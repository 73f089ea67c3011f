"""The port's four examples print the reference's lines.

Each reference example (``examples/<name>.py``) and its port
(``examples/<name>_torch.py --device cpu``) run side by side in
subprocesses at the reference's sizes and seeds, each under a ``TMPDIR``
of its own inside the test's ``tmp_path`` (the examples write to fixed
directories under ``tempfile.gettempdir()``: the quickstart's store, the
trainer's checkpoints, which a second run would resume from).  Their
lines are compared with the times, speedups, losses, the port's labels of
where a time was taken and the temporary directory masked
(``examples/_torch_example.py:deterministic_lines``): counts, bytes,
requests, the page-cache and filter counters and the tenants must be
equal.  The training example runs 3 steps; its initial weights come from
torch's generator, so its losses only have to be finite.
"""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
sys.path.insert(0, str(EXAMPLES))
from _torch_example import deterministic_lines  # noqa: E402

#: example -> the arguments both legs take
CASES = {"quickstart": [], "ldbc_queries": [], "serve_batched": [],
         "train_graph_corpus": ["--steps", "3"]}
TIMEOUT_S = 300


def _run_pair(name, args, tmp_path):
    """(reference stdout, port stdout, their TMPDIRs), both run at once."""
    legs = []
    for leg, script, extra in (
            ("ref", f"{name}.py", []),
            ("port", f"{name}_torch.py", ["--device", "cpu"])):
        tmp = tmp_path / leg
        tmp.mkdir()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   TMPDIR=str(tmp), JAX_PLATFORMS="cpu")
        legs.append((tmp, subprocess.Popen(
            [sys.executable, str(EXAMPLES / script)] + args + extra,
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    outs = []
    try:
        for tmp, p in legs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append((out, str(tmp)))
    finally:
        for _, p in legs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.mark.parametrize("name", list(CASES))
def test_port_example_prints_the_references_lines(name, tmp_path):
    (ref, ref_tmp), (port, port_tmp) = _run_pair(name, CASES[name],
                                                 tmp_path)
    want = deterministic_lines(ref, ref_tmp)
    got = deterministic_lines(port, port_tmp)
    assert len(want) > 3
    assert got == want
    if name == "train_graph_corpus":
        losses = [float(x) for x in re.findall(r"loss (\d+\.\d+|nan|inf)",
                                               port)]
        assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    # the port's measured times say where they were taken (the ESSD
    # figures are the storage model's, from the bytes read)
    timed = [line for line in port.splitlines()
             if re.search(r" ms \||s/step|\(sort ", line)]
    assert bool(timed) == (name != "serve_batched")     # it prints none
    assert all(line.rstrip().endswith("]") for line in timed)
