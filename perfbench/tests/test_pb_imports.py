"""What the benchmark loads: a rehearsed run loads no module whose top-level
name is jax, jaxlib, flax or tf2_tpu (compared whole: ``tf2_tpu_torch`` is
the program); the reference loads nothing of the program."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

REHEARSE = """
import json, sys
from perfbench.run import loaded_forbidden
from perfbench.tests import tiny
outs = [tiny.run(w, traced=True, seconds=0.3) for w in tiny.WORKLOADS]
print(json.dumps({"bad": loaded_forbidden(), "top": sorted({m.split(".")[0] for m in sys.modules}),
                  "correct": all(o["correct"] for o in outs)}))
"""

REFERENCE = """
import json, sys, torch
from perfbench import reference
from perfbench.reference import files
graph, arrays = files.load(sys.argv[1])
x = torch.zeros(1, 32, 32, 3)
reference.forward(graph, {k: torch.from_numpy(v) for k, v in arrays.items()}, x)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _run(code, *args):
    p = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_rehearsed_run_loads_no_jax():
    out = _run(REHEARSE)
    assert out["correct"] is True
    assert out["bad"] == []
    assert "tf2_tpu_torch" in out["top"]
    assert not {"jax", "jaxlib", "flax", "tf2_tpu"} & set(out["top"])


def test_reference_loads_nothing_of_the_program(tmp_path):
    from perfbench import artifact
    from perfbench.tests import tiny

    d = artifact.make(tiny.config("vit-b16-w8"), 1, "cpu", tmp_path)
    top = set(_run(REFERENCE, str(d)))
    assert not {"tf2_tpu_torch", "tf2_tpu", "jax", "jaxlib", "flax"} & top


def test_forbidden_names_are_whole():
    from perfbench.run import loaded_forbidden

    sys.modules.setdefault("tf2_tpu_torch_like", sys)
    try:
        assert "tf2_tpu" not in loaded_forbidden()
    finally:
        del sys.modules["tf2_tpu_torch_like"]
