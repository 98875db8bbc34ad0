"""Nothing the harness loads brings in JAX or the JAX package, nothing of
it reads the JAX package's benchmarks, and no reference or architecture
file imports the program."""

import json
import subprocess
import sys

import pytest

from perfbench import run

PROBE = r"""
import sys
sys.path[:0] = [{src!r}, {root!r}]
from perfbench import run, check, generator, spec, trace, weights, work, kernel_names
from perfbench.reference import common, mixtral
import perfbench.control
for p in sorted((run.HERE / "drivers").glob("*.py")):
    run.load_module(p, "d_" + p.stem)
for p in sorted((run.HERE / "metrics").glob("*.py")):
    run.load_module(p, "m_" + p.stem.replace(".", "_"))
for p in sorted((run.HERE / "arch").glob("*.py")):
    run.load_module(p, "a_" + p.stem)
# what the drivers import from the program when they run
import repro_torch.training.trainer, repro_torch.training.step, repro_torch.optim.adamw
import repro_torch.configs
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_no_jax_or_jax_package_is_loaded():
    code = PROBE.format(src=str(run.ROOT / "src"), root=str(run.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    tops = set(eval(out.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "perfbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops & {"jax", "jaxlib", "flax", "repro"}


def _plain_files() -> list:
    """Every reference a configuration names, every file beside them under
    ``reference/``, and every architecture file."""
    named = {json.loads(c.read_text())["reference"]
             for c in sorted((run.HERE / "configs").glob("*.json"))}
    beside = {p.relative_to(run.HERE).as_posix()
              for d in ("reference", "arch") for p in (run.HERE / d).glob("*.py")
              if p.name != "__init__.py"}
    return sorted(named | beside)


def test_every_configuration_names_a_reference_and_an_architecture_file():
    for c in sorted((run.HERE / "configs").glob("*.json")):
        cfg = json.loads(c.read_text())
        assert (run.HERE / cfg["reference"]).is_file(), c
        assert (run.HERE / "arch" / f"{cfg['arch']}.py").is_file(), c


@pytest.mark.parametrize("path", _plain_files())
def test_the_reference_imports_nothing_of_the_program(path):
    text = (run.HERE / path).read_text()
    assert "repro" not in text and "jax" not in text, path


def test_nothing_reads_the_jax_packages_benchmarks():
    for p in run.HERE.rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, p
