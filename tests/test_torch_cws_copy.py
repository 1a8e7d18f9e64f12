"""The port's copy of the CWS core is ``repro``'s, byte for byte.

The scheduler core, the CWSI, the executor, the node profiles and the
orchestrator are pure Python; the port keeps its own copy so that it imports
nothing of ``repro``. Their relative imports read the same in both packages,
so each file must equal ``repro``'s line for line, except the lines listed
in DIFFERING with their reason: this guards the copy against drift.
"""
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

COPIED = ["core/dag.py", "core/node_index.py", "core/provenance.py", "core/predict.py",
          "core/strategies.py", "core/arbiter.py", "core/commands.py",
          "core/scheduler.py", "core/cwsi.py", "cluster/nodes.py",
          "cluster/executor.py", "runtime/orchestrator.py"]

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


def test_the_port_keeps_what_it_left_out_out():
    """The modules of ``repro`` the port has no copy of are not half there:
    the packages' ``__init__`` files import none of them."""
    for pkg, left_out in (("core", ("journal", "cwsi_http", "cwsi_client")),
                          ("cluster", ("faults", "simulator", "traces"))):
        init = (SRC / "repro_torch" / pkg / "__init__.py").read_text()
        for mod in left_out:
            assert not (SRC / "repro_torch" / pkg / f"{mod}.py").exists()
            assert f".{mod} import" not in init, (pkg, mod)
