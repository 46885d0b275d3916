"""Tiny sizes for the CPU tests of cells whose driver ``tests/tiny.py``
does not list: a driver that streams as ``drivers/stream.py`` does (its
mix's keys and its window) takes the stream's tiny traffic.

``vgg16-stream`` runs there at configuration D's published widths on the
tiny faces: ``lib/weights_vgg16.py`` takes no ``base_width``.  Cut to
widths 8-64, the tiny maps are so flat (a range of 0.02-0.06) that the
host remap's fixed-point taps alone read a ``map_gap`` up to 0.11 of it
against the float32 reference (0.0007 with the host's faces in the
reference's place): past the cell's limit, with the program right."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

import tiny  # noqa: E402

tiny.TINY_TRAFFIC.setdefault("stream_vgg16", tiny.TINY_TRAFFIC["stream"])
