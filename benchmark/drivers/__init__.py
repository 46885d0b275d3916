"""The traffic generators: one module per ``driver`` a mix file names,
each with ``setup``, ``window``, ``release`` and ``check`` hooks."""
