"""One rank of the distributed suite's gloo worlds.

Run as ``python _torch_dist_worker.py RANK WORLD PORT DIR SHAPE AXES``:
the rank joins a gloo world of WORLD ranks at ``tcp://localhost:PORT``
(collectives time out after 120 s), lays the mesh SHAPE (comma separated)
over AXES (comma separated), reads ``DIR/inputs.pt`` (written by
``test_torch_distributed.py`` or ``test_torch_distributed_families.py``)
and writes ``DIR/rank{RANK}.pt``: every case's global results (gathered,
the same on every rank) and the rank's own parts.  Only ``repro_torch``
is imported: ``jax_loaded`` records whether anything pulled JAX in.
"""
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import save_checkpoint
from repro_torch.checkpoint.reshard import (device_put_resharded,
                                            elastic_restore)
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (place, rank_slices,
                                              shard_params,
                                              tree_leaves_with_path)
from repro_torch.launch.mesh import distributed_mesh, init_world
from repro_torch.models import build_model
from repro_torch.models.model import shard_model
from repro_torch.train import optimizer as TO
from repro_torch.train.train_step import (make_train_step, model_params,
                                          unit_layout)


def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def full_tree(tree):
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return full(tree).detach().clone() if isinstance(tree, torch.Tensor) \
        else tree


def optimizer(kind: str, lr: float, eps: float):
    if kind == "adafactor":
        return TO.adafactor(lr)
    return TO.adamw(lr, eps=eps, moment_dtype=kind)


def run_model(case, mesh):
    cfg = get_config(case["arch"]).reduced()
    model = build_model(cfg, "cpu")
    model.load_state_dict(case["state"])
    shard_model(model, mesh)
    b = case["batch"]
    # the cross context (encoder frames, vision embeddings), if any
    ctx = {k: v for k, v in b.items() if k in ("frames", "vision")}
    res = {}
    with mesh:
        with torch.no_grad():
            logits, _ = model.forward({"tokens": b["tokens"], **ctx})
        res["logits"] = full(logits)
        res["jax_loaded"] = "jax" in sys.modules
        if case.get("flash"):  # kernel 15 on local heads or query rows
            fm = build_model(cfg.with_(use_flash=True), "cpu")
            fm.load_state_dict(case["state"])
            shard_model(fm, mesh)
            with torch.no_grad():
                res["flash_logits"] = full(fm.forward(
                    {"tokens": b["tokens"], **ctx})[0])
            if case.get("flash_only"):
                return res
        params = dict(model.named_parameters())
        loss, _ = model.loss(b)
        grads = torch.autograd.grad(loss, list(params.values()))
        res["loss"] = float(full(loss))
        res["grads"] = {n: full(g) for n, g in zip(params, grads)}
        res["placements"] = {n: str(tuple(p.placements))
                             for n, p in params.items()}
        prompt = b["tokens"][:, :case["prompt"]]
        cache = model.init_cache(prompt.shape[0],
                                 case["prompt"] + case["decode"],
                                 ctx_len=case.get("ctx_len", 0),
                                 dtype=torch.float32)
        res["cache_placements"] = {
            f"{i}/{kind}/{leaf}": str(tuple(t.placements))
            for i, layer in enumerate(cache["layers"])
            for kind, c in layer.items() for leaf, t in c.items()
            if hasattr(t, "placements")}
        lg, cache = model.prefill({"tokens": prompt, **ctx}, cache)
        lg = full(lg)
        steps, toks = [lg], []
        for _ in range(case["decode"]):
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
            lg, cache = model.decode_step(tok, cache)
            lg = full(lg)
            steps.append(lg)
        res["decode_logits"] = steps
        res["greedy"] = torch.cat(toks, 1)
        if "slots" in case:
            res["slots"] = run_slots(model, b["tokens"], case["slots"])
        if "routing" in case:
            res["routing"] = run_routing(model, cfg, case["routing"], mesh)
        res["train"] = {}
        for name, (kind, lr, n_micro, n_steps) in case["train"].items():
            opt = optimizer(kind, lr, case["eps"])
            p = model_params(model)
            state = opt.init(p, unit_layout(model))
            state = place(state, shard_params(state, mesh, cfg))
            step = make_train_step(model, opt, n_micro)
            mets = []
            for _ in range(n_steps):
                p, state, m = step(p, state, b)
                mets.append({k: float(v) for k, v in m.items()})
            res["train"][name] = {"params": full_tree(p),
                                  "state": full_tree(state),
                                  "metrics": mets}
            if name == case.get("checkpoint"):
                save_checkpoint(case["ckpt_dir"], n_steps,
                                {"params": p, "opt": state},
                                extra={"next_step": n_steps})
    return res


def run_slots(model, tokens, case):
    """Per-slot prefill and decode on the ambient mesh (see
    ``tests/_torch_slots.py``): each group prefilled into a scalar-index
    cache of its width and written into its slots of a vector-index
    cache by ``write_slots``, then every slot decoded at its own
    position."""
    from repro_torch.serve.steps import write_slots
    b = tokens.shape[0]
    cache = model.init_cache(b, case["max_len"], dtype=torch.float32,
                             vector_index=True)
    first = torch.zeros((b, 1), dtype=torch.int32)
    pre = []
    for slots, n in case["groups"]:
        tmpl = model.init_cache(len(slots), case["max_len"],
                                dtype=torch.float32)
        lg, tmp = model.prefill({"tokens": tokens[list(slots), :n]}, tmpl)
        write_slots(cache, tmp, slots)
        lg = full(lg)
        pre.append(lg)
        first[list(slots), 0] = lg[:, -1].argmax(-1).to(torch.int32)
    tok, toks, steps = first, [first], []
    for _ in range(case["decode"]):
        lg, cache = model.decode_step(tok, cache)
        lg = full(lg)
        steps.append(lg)
        tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok)
    return {"prefill": pre, "decode": steps, "greedy": torch.cat(toks, 1),
            "placements": {leaf: str(tuple(t.placements)) for leaf, t in
                           cache["layers"][0].get("kv", {}).items()}}


def run_routing(model, cfg, x, mesh):
    """The first MoE layer on the mesh over ``x`` [B, S, d] (the global
    batch, placed over the data axes): its global routing (expert ids,
    ``keep``) and its output, gathered."""
    from repro_torch.distributed.sharding import spmd
    from repro_torch.models.moe import moe_apply, route_global
    block = next(b for b in model.blocks() if hasattr(b, "moe"))
    m = cfg.moe
    kw = dict(num_experts=m.num_experts, top_k=m.top_k,
              capacity_factor=m.capacity_factor)
    with spmd(), torch.no_grad():
        *_, r = route_global(block.moe, x, mesh, **kw)
        y, aux = moe_apply(block.moe, x, **kw)
    return {"experts": r["experts"], "keep": r["keep"],
            "capacity": r["capacity"], "y": full(y), "aux": float(full(aux))}


def run_elastic(case, mesh):
    """This rank's parts of ``elastic_restore`` and of
    ``device_put_resharded`` onto the mesh, with its slices (the port's
    parameter names where ``case`` names the ``arch``)."""
    cfg = get_config(case["arch"]).reduced() if "arch" in case else None
    tree, extra = elastic_restore(case["dir"], case["step"], case["like"],
                                  mesh, cfg)
    put = device_put_resharded(case["like"], mesh, cfg)
    shardings = dict(tree_leaves_with_path(shard_params(case["like"], mesh,
                                                        cfg)))
    out = {"extra": extra, "parts": {}, "put": {}, "slices": {}}
    for path, leaf in tree_leaves_with_path(tree):
        key = "/".join(str(k) for k in path)
        out["parts"][key] = leaf.to_local().clone()
        out["slices"][key] = rank_slices(shardings[path], leaf.shape)
        out["placements"] = str(tuple(leaf.placements))
    for path, leaf in tree_leaves_with_path(put):
        out["put"]["/".join(str(k) for k in path)] = leaf.to_local().clone()
    return out


def run_pipeline(case, mesh):
    import repro_torch.core as C
    from repro_torch.data.pipeline import (GraphCorpusPipeline,
                                           PipelineConfig, data_shard,
                                           global_batch)
    from repro_torch.data.synthetic import document_graph
    lake = document_graph(**case["lake"])
    b = C.GraphArBuilder("corpus")
    b.add_vertices(
        C.VertexTypeSchema("doc", [C.PropertySchema("tokens", "tokens")],
                           labels=list(lake.labels), page_size=128),
        {"tokens": lake.tokens}, lake.labels)
    b.add_edges(C.EdgeTypeSchema("doc", "links", "doc", page_size=128),
                lake.links_src, lake.links_dst)
    cond = (C.L("HighQuality") | C.L("News")) & ~C.L("Spam")
    pipe = GraphCorpusPipeline(b.build(), cond,
                               PipelineConfig(seq_len=32, batch_size=2),
                               engine="torch", mesh=mesh)
    first = next(pipe.batches())
    glob = global_batch({"tokens": first["tokens"]}, mesh)["tokens"]
    return {"shard": data_shard(mesh), "eligible": pipe.eligible,
            "tokens": first["tokens"], "global": full(glob),
            "global_shape": tuple(glob.shape)}


def run_trainer(case, mesh):
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.data.pipeline import data_shard
    cfg = get_config("smollm-360m").reduced()
    shard, n = data_shard(mesh)
    rows = case["tokens"].shape[1] // n

    def batch_fn(step):
        sl = slice(shard * rows, (shard + 1) * rows)
        return {"tokens": case["tokens"][step, sl],
                "labels": case["labels"][step, sl]}

    tr = Trainer(build_model(cfg, "cpu"),
                 TO.adamw(case["lr"], eps=case["eps"]),
                 TrainerConfig(**case["config"]), batch_fn, mesh=mesh)
    out = tr.run(simulate_failure_at=case["fail_at"])
    return {"history": [h["loss"] for h in out["history"]],
            "failures": out["failures"], "final_step": out["final_step"],
            "params": full_tree(out["params"])}


def main(argv):
    rank, world, port = (int(a) for a in argv[:3])
    root = argv[3]
    shape = tuple(int(x) for x in argv[4].split(","))
    axes = tuple(argv[5].split(","))
    torch.set_num_threads(1)
    init_world(rank, world, f"tcp://localhost:{port}", backend="gloo",
               timeout_s=120)
    mesh = distributed_mesh(shape, axes)
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    out = {"coordinate": mesh.coordinate()}
    for name, case in inp["models"].items():
        out[name] = run_model(case, mesh)
    for name, run in (("elastic", run_elastic), ("pipeline", run_pipeline),
                      ("trainer", run_trainer)):
        if name in inp:
            out[name] = run(inp[name], mesh)
    out["jax_loaded"] = "jax" in sys.modules
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
