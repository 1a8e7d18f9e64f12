"""The port's copy of the CWS is ``repro``'s, byte for byte.

The scheduler core, the CWSI and its HTTP transport and retrying client, the
journal, the executor, the node profiles, the discrete-event simulator, its
fault plans, the nf-core traces and the orchestrator are pure Python; the
port keeps its own copy so that it imports nothing of ``repro``. Their relative imports read the same in both packages,
so each file must equal ``repro``'s line for line, except the lines listed
in DIFFERING with their reason: this guards the copy against drift.
"""
import importlib
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

COPIED = ["core/dag.py", "core/node_index.py", "core/provenance.py", "core/predict.py",
          "core/strategies.py", "core/arbiter.py", "core/commands.py",
          "core/scheduler.py", "core/cwsi.py", "core/journal.py", "core/cwsi_http.py",
          "core/cwsi_client.py", "cluster/nodes.py", "cluster/executor.py",
          "cluster/faults.py", "cluster/simulator.py", "cluster/traces.py",
          "runtime/orchestrator.py"]
PACKAGES = ("core", "cluster")

# file -> {line number: the port's line}. Why: ``repro``'s comment there
# names pull requests of its own history by number; the port's copy says
# the same without the numbers.
DIFFERING = {
    "core/arbiter.py": {
        290: "    to the first incremental engine; the golden-trace suite holds it there.\n"},
    "core/node_index.py": {
        3: "Earlier work made the *event and ordering* path incremental, but every\n"},
}


@pytest.mark.parametrize("name", COPIED)
def test_module_is_a_byte_copy_of_repro(name):
    theirs = (SRC / "repro" / name).read_text().splitlines(keepends=True)
    ours = (SRC / "repro_torch" / name).read_text().splitlines(keepends=True)
    allowed = DIFFERING.get(name, {})
    assert len(ours) == len(theirs), name
    differ = {i for i, (a, b) in enumerate(zip(theirs, ours), 1) if a != b}
    assert differ == set(allowed), (name, sorted(differ))
    for i, line in allowed.items():
        assert ours[i - 1] == line, (name, i)


def test_every_cws_module_of_repro_has_its_copy():
    """Nothing of ``repro``'s ``core/`` and ``cluster/`` is left out of the
    port: each module is in COPIED (and so checked byte for byte above)."""
    for pkg in PACKAGES:
        theirs = sorted(f"{pkg}/{f.name}" for f in (SRC / "repro" / pkg).glob("*.py")
                        if f.name != "__init__.py")
        assert theirs and all(name in COPIED for name in theirs), (pkg, theirs)
        assert all((SRC / "repro_torch" / name).exists() for name in theirs)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_the_names_repro_exports(pkg):
    """The ``__init__`` of the port's ``core`` and ``cluster`` export what
    ``repro``'s do, name for name."""
    def exported(mod):
        m = importlib.import_module(mod)
        return {n for n in vars(m) if not n.startswith("_")}

    assert exported(f"repro_torch.{pkg}") == exported(f"repro.{pkg}")
