"""Render dry-run JSON reports into tables.

The JAX package's ``launch/report.py`` on PyTorch, the fit measured
against one H100's 80e9 bytes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.report \\
      --single dryrun_single.json --multi dryrun_multi.json
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.launch.roofline import HBM_BYTES, active_params
from repro_torch.launch.shapes import SHAPES


def analytic_memory_floor(arch: str, shape_name: str, chips: int,
                          multi_pod: bool) -> Dict[str, float]:
    """Per-device HBM bytes floor: params+opt+cache (exact) + one
    microbatch of saved activations (analytic).  The meta trace has no
    buffer-liveness model, so the fit proof uses this floor plus the exact
    argument sizes."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = active_params(cfg)
    total_params = n
    if cfg.moe:
        moe_layers = sum(1 for s in (list(cfg.prefix)
                                     + list(cfg.unit) * cfg.n_units)
                         if s.moe)
        total_params = n + (cfg.moe.num_experts - cfg.moe.top_k) * 3 \
            * cfg.d_model * cfg.moe.d_expert * moe_layers
    dp = chips  # params FSDP over everything they can shard over
    out: Dict[str, float] = {}
    if shape.kind == "train":
        moment_bytes = {"int8": 2.2, "bfloat16": 4, "float32": 8}
        if total_params > 100e9:
            mb = moment_bytes["int8"]
        elif total_params > 10e9:
            mb = moment_bytes["bfloat16"]
        else:
            mb = moment_bytes["float32"]
        state = total_params * (2 + 2 + mb) / chips  # bf16 p + bf16 g + m,v
        micro_tokens = shape.batch * shape.seq / cfg.train_microbatches
        n_layers = cfg.num_layers
        saved = micro_tokens * cfg.d_model * 2 * n_layers / chips
        logits = micro_tokens * cfg.vocab_size * 6 / chips
        out["state_bytes"] = state
        out["activation_bytes"] = saved + logits
        out["floor_bytes"] = state + saved + logits
    else:
        params_b = total_params * 2 / chips
        # cache bytes: attention layers * 2 * kv * dh * L * batch * 2
        specs = list(cfg.prefix) + list(cfg.unit) * cfg.n_units
        cache = 0.0
        for s in specs:
            if s.kind == "attn":
                cache += (2 * cfg.num_kv_heads * cfg.head_dim * shape.seq
                          * shape.batch * 2)
            else:
                ssm = cfg.ssm
                cache += (ssm.num_heads * ssm.head_dim * ssm.state_dim
                          * 4 * shape.batch)
        cache /= chips
        act = shape.batch * min(shape.seq, 32768) * cfg.d_model * 2 / chips \
            if shape.kind == "prefill" else \
            shape.batch * cfg.d_model * 2
        out["state_bytes"] = params_b
        out["activation_bytes"] = cache + act
        out["floor_bytes"] = params_b + cache + act
    out["fits_floor_h100_80gb"] = out["floor_bytes"] <= HBM_BYTES
    return out


def _fmt(x: Optional[float], unit: str = "") -> str:
    if x is None:
        return "-"
    if x == 0:
        return "0"
    for thresh, suffix, div in ((1e12, "T", 1e12), (1e9, "G", 1e9),
                                (1e6, "M", 1e6), (1e3, "k", 1e3)):
        if abs(x) >= thresh:
            return f"{x/div:.2f}{suffix}{unit}"
    return f"{x:.3g}{unit}"


def next_lever(r: Dict) -> str:
    """One sentence: what would move this cell's dominant term down."""
    arch, shape, b = r["arch"], r["shape"], r["bottleneck"]
    cfg = get_config(arch)
    if shape.startswith("decode") or shape.startswith("long"):
        if b == "memory":
            return ("each token streams the weights and the cache once: "
                    "a wider batch or int8 weights cut the bytes a token; "
                    "the plain route's GQA expansion copies K/V a layer")
        return ("decode is compute-bound only at wide batches: the plain "
                "route's float32 scores are the next to go")
    if shape.startswith("prefill"):
        if b == "collective":
            return ("a ring hand-off of K/V between cards would replace "
                    "the all-gather of sequence-parallel attention")
        return ("the plain route's float32 [B, H, S, S] scores dominate the "
                "bytes: kernel 15 keeps them on chip (the flash route, "
                "use_flash=True, for inference)")
    # train
    if b == "collective":
        if cfg.moe:
            return ("the all-to-all is the expert dispatch floor: dispatch "
                    "inside a node first (NVLink) before crossing nodes")
        return ("overlap the FSDP weight gathers with the previous layer's "
                "compute and reduce-scatter the gradients in bf16")
    if b == "memory":
        return ("kernel 15 keeps the scores on chip but has no backward, so "
                "training takes the plain route's float32 scores: a flash "
                "backward removes that traffic")
    return "compute-bound: at the tensor cores' roof for this shape"


def roofline_table(rows: List[Dict]) -> str:
    out = ["| arch | shape | t_compute (s) | t_memory (s) | t_coll (s) | "
           "bottleneck | MODEL_FLOPS | useful ratio | roofline frac | "
           "coll bytes/dev | what moves the dominant term |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r.get("status") != "ok":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3g} | "
            f"{r['t_memory_s']:.3g} | {r['t_collective_s']:.3g} | "
            f"{r['bottleneck']} | {_fmt(r['model_flops'])} | "
            f"{r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.4f} | "
            f"{_fmt(r['coll_ici_bytes'] + r['coll_dcn_bytes'], 'B')} | "
            f"{next_lever(r)} |")
    return "\n".join(out)


def dryrun_table(rows: List[Dict], multi_pod: bool) -> str:
    out = ["| arch | shape | status | trace (s) | args/dev | "
           "floor/dev (analytic) | fits 80GB | coll ops |",
           "|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | FAIL | - | - | - |"
                       f" - | - |")
            continue
        mem = r.get("memory") or {}
        args = mem.get("argument_size_in_bytes")
        floor = analytic_memory_floor(r["arch"], r["shape"], r["chips"],
                                      multi_pod)
        fits = floor["fits_floor_h100_80gb"] and \
            (args or 0) <= HBM_BYTES
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']:.1f} | "
            f"{_fmt(args, 'B')} | {_fmt(floor['floor_bytes'], 'B')} | "
            f"{'yes' if fits else 'NO'} | {r.get('coll_count', 0)} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--single", default="dryrun_single.json")
    ap.add_argument("--multi", default="dryrun_multi.json")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with open(args.single) as f:
        single = json.load(f)
    with open(args.multi) as f:
        multi = json.load(f)
    parts = [
        "### Dry-run: single pod (16x16 = 256 cards)",
        dryrun_table(single, False), "",
        "### Dry-run: multi-pod (2x16x16 = 512 cards)",
        dryrun_table(multi, True), "",
        "### Roofline (single pod, one traced microbatch scaled)",
        roofline_table(single), "",
    ]
    text = "\n".join(parts)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
