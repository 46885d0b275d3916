"""No module a run or the reference loads is JAX's or the JAX package's
(compared by whole top-level name), and the reference loads nothing of the
program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import sys, glob
sys.path.insert(0, {root!r})
{imports}
tops = {{m.split('.', 1)[0] for m in sys.modules}}
print(sorted(tops & {{'jax', 'jaxlib', 'flax', 'cp360_tpu', 'cp360_tpu_torch'}}))
"""


def _loaded(imports: str):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), imports=imports)],
                         capture_output=True, text=True, check=True, timeout=300)
    return out.stdout.strip().splitlines()[-1]


def test_harness_loads_no_jax():
    imports = """
from benchmark import harness
from benchmark.drivers import stream, train
from benchmark.lib import port
port.program_config({'config': {}})
import cp360_tpu_torch.pipelines.stream, cp360_tpu_torch.train.loop
import cp360_tpu_torch.data.dataset
for path in glob.glob({root!r} + '/benchmark/metrics/*.py'):
    harness.load_metric_reader(path.rsplit('/', 1)[1][:-3])
""".replace("{root!r}", repr(str(ROOT)))
    assert _loaded(imports) == "['cp360_tpu_torch']"


def test_reference_loads_nothing_of_the_program():
    assert _loaded("import benchmark.reference.model, benchmark.reference.geometry") == "[]"
