"""The device of the port's examples (``--device {cuda,cpu}``), and the
lines of an example's output that do not depend on where or how fast it
ran.

``cuda`` (the default) runs the hand-written kernels (``engine="cuda"``)
and the model on ``cuda:0`` and raises when there is no card; ``cpu``
runs the kernels' plain PyTorch versions (``engine="torch"``) and the
model on the CPU.  Nothing falls back from one to the other."""
import re
import subprocess

import torch


def add_device_arg(ap) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the kernels and the model run (default: "
                    "cuda, which needs a card)")


def open_device(name: str):
    """(engine, torch device, the label that goes beside a time).  On the
    card, prints its name and power limit on a line of their own."""
    if name == "cpu":
        return "torch", torch.device("cpu"), "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the example runs on the card by "
                           "default (pass --device cpu to run on the CPU)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {card}")
    return "cuda", torch.device("cuda", 0), "cuda:0"


#: (pattern, replacement) of what differs from run to run: a time or a
#: modeled time, a speedup, a loss or a gradient norm (the padding of a
#: time's column with it)
_MASKS = ((re.compile(r"\s*\d+\.\d+ ?ms\b"), " # ms"),
          (re.compile(r"\d+\.\d+(s\b|s/step|x)"), r"#\1"),
          (re.compile(r"(\bloss|\bgnorm|->) \d+\.\d+"), r"\1 #"))
#: the label a timed line ends with, saying where each side ran
_LABEL = re.compile(r"\s+\[[^\]]*\]$")


def deterministic_lines(out: str, tmpdir: str = "") -> list:
    """``out``'s lines without the card's line, the labels of where a
    time was taken, the times, speedups and losses, and ``tmpdir`` (the
    ``TMPDIR`` it ran under): counts, bytes, requests, the page-cache
    and filter counters and the tenants stay."""
    lines = []
    for line in out.splitlines():
        if line.startswith("device: "):
            continue
        if tmpdir:
            line = line.replace(tmpdir, "<tmp>")
        line = _LABEL.sub("", line)
        for pat, rep in _MASKS:
            line = pat.sub(rep, line)
        lines.append(line)
    return lines
