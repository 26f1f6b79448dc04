"""Multi-process gloo worlds on the CPU for the port's mesh tests.

:func:`run_world` spawns ``world`` processes, each joins a gloo (or, one
card a rank, NCCL) process group through a file store in the world's
own directory, runs one of the worker functions below (by name) and
saves what it returns (a dict of numpy arrays) as ``rank{r}.npz``; the
parent gets one dict per rank.  A world that does not
finish within ``timeout`` seconds is killed and fails the test.  The
workers import torch and the port only (never jax), single-threaded.
"""
from __future__ import annotations

import copy
import dataclasses
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, world: int, fn: str, args: dict, out: str,
           backend: str) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    # a file store in the world's own directory: worlds started at once
    # (one per test worker) never meet on a port
    dist.init_process_group(backend, init_method=f"file://{out}/store",
                            rank=rank, world_size=world)
    try:
        res = globals()[fn](rank, world, **args)
        np.savez(Path(out) / f"rank{rank}.npz",
                 **{k: np.asarray(v) for k, v in (res or {}).items()})
    except BaseException:
        (Path(out) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_world(fn: str, world: int, timeout: float = 300.0,
              backend: str = "gloo", **args) -> list:
    """Run worker ``fn`` on ``world`` ranks (gloo; ``"nccl"``: one card a
    rank); their results by rank."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out:
        procs = [ctx.Process(target=_entry,
                             args=(r, world, fn, args, out, backend))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        errs = sorted(Path(out).glob("*.err"))
        assert not errs, "\n".join(e.read_text() for e in errs)
        assert not alive, f"world {fn} x{world} ran past {timeout} s"
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
        return [dict(np.load(Path(out) / f"rank{r}.npz"))
                for r in range(world)]


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _f32(arch: str):
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _moe_cfg(style: str):
    from repro_torch.models.common import ModelConfig, MoEConfig

    mc = (MoEConfig(n_experts=8, top_k=2, d_expert=64) if style == "mixtral"
          else MoEConfig(n_experts=2, top_k=2, d_expert=128))
    return ModelConfig(name=style, family="moe", n_layers=1, d_model=32,
                       n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                       vocab_size=64, dtype="float32", moe=mc)


def _moe_params(inp: dict, prefix: str, model_size: int):
    from repro_torch.models import moe

    wg, wu, wd = (_t(inp[f"{prefix}_{k}"]) for k in ("wg", "wu", "wd"))
    cg, cu, cd = moe.to_chunked(wg, wu, wd, model_size)
    return {"router": _t(inp[f"{prefix}_router"]),
            "experts": {"w_gate": cg, "w_up": cu, "w_down": cd}}


# ---------------------------------------------------------------------------
# the 8-rank world of tests/test_torch_sharded.py
# ---------------------------------------------------------------------------

def _moe_cases(inp: dict, mesh) -> dict:
    """The sharded MoE paths on the (2, 4) mesh, as the reference's tests
    run them; the port's own dense oracle beside each."""
    from repro_torch.models import moe

    out = {}
    cfg = _f32("mixtral-8x7b")
    p1 = _moe_params(inp, "mix", 1)
    p4 = _moe_params(inp, "mix", 4)
    kw = dict(batch_axes=("data",))
    for cf in (8.0, 1.0):
        tag = int(cf)
        x = _t(inp[f"mix_x{tag}"])
        out[f"rep{tag}"] = moe.moe_sharded(p4, x, cfg, mesh,
                                           capacity_factor=cf, **kw)
        out[f"a2a{tag}"] = moe.moe_sharded_a2a(p4, x, cfg, mesh,
                                               capacity_factor=cf, **kw)
        out[f"mix_ref{tag}"] = moe.moe_ref(p1, x, cfg)
    x = _t(inp["mix_x8"])
    moe._DISPATCH_CACHE.clear()
    out["auto8"] = moe.moe_apply(p4, x, cfg, mesh, capacity_factor=8.0, **kw)
    (key,) = moe._DISPATCH_CACHE
    out["auto_key"] = np.asarray(key)
    out["auto_verdict"] = np.asarray(moe._DISPATCH_CACHE[key])
    for style in ("mixtral", "deepseek"):
        scfg = _moe_cfg(style)
        x = _t(inp[f"{style}_x"])
        out[f"tp_{style}"] = moe.moe_apply(
            _moe_params(inp, style, 4), x, scfg, mesh, dispatch="a2a",
            capacity_factor=8.0, **kw)
        out[f"tp_{style}_ref"] = moe.moe_ref(_moe_params(inp, style, 1), x,
                                             scfg)
    x = _t(inp["ragged_x"])
    out["ragged"] = moe.moe_apply(p4, x, cfg, mesh, dispatch="a2a",
                                  capacity_factor=8.0, **kw)
    out["ragged_ref"] = moe.moe_ref(p1, x, cfg)
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def _moe_grads(inp: dict, mesh) -> dict:
    """Gradients through both sharded paths (no drops), each rank's summed
    over the mesh as the train step sums them, and the dense oracle's."""
    from repro_torch.dist import comm
    from repro_torch.models import moe

    cfg = _f32("mixtral-8x7b")
    x0, w = _t(inp["mix_x8"]), _t(inp["mix_w"])
    out = {}
    for name, fn, ms in (("ref", moe.moe_ref, 1),
                         ("rep", moe.moe_sharded, 4),
                         ("a2a", moe.moe_sharded_a2a, 4)):
        p = _moe_params(inp, "mix", ms)
        x = x0.clone().requires_grad_(True)
        leaves = [p["router"], *p["experts"].values()]
        for t in leaves:
            t.requires_grad_(True)
        if ms == 1:
            y = fn(p, x, cfg)
        else:
            y = fn(p, x, cfg, mesh, batch_axes=("data",),
                   capacity_factor=8.0)
        grads = torch.autograd.grad((y * w).sum(), [x, *leaves])
        if ms > 1:
            # every rank's part summed over the batch axis; each expert
            # chunk's gradient lives on its model rank alone
            comm.all_reduce_(grads, mesh, "data")
            comm.all_reduce_(grads[2:], mesh, "model")
            out[f"{name}_gx"] = grads[0].numpy()
            out[f"{name}_grouter"] = grads[1].numpy()
            for k, g in zip(("wg", "wu", "wd"), grads[2:]):
                out[f"{name}_g{k}"] = g.numpy()
        else:
            out["ref_gx"], out["ref_grouter"] = grads[0].numpy(), \
                grads[1].numpy()
            for k, g in zip(("wg", "wu", "wd"), grads[2:]):
                # the dense oracle's [1, E, ...] in the chunked layout of 4
                cg = moe.to_chunked(*(grads[2 + i][0] for i in range(3)), 4)
                out[f"ref_g{k}"] = cg[("wg", "wu", "wd").index(k)].numpy()
    return out


def _decode(cfg, ctx, params, caches, toks, pos):
    from repro_torch.models import decoder

    return decoder.decode_step(cfg, ctx, params, caches, toks, pos)


def _seq_decode_cases(rank: int) -> dict:
    """Two decode steps over seq-sharded rings against the single-device
    step (the reference's test_seq_sharded_decode_matches_unsharded), a
    step of three tokens after them, and a prefill on the same mesh."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models import common, decoder

    out = {}
    for arch, shape in (("glm4-9b", (1, 4, 2)),
                        ("deepseek-v2-236b", (2, 4, 1))):
        tag = arch.split("-")[0]
        cfg = _f32(arch)
        params = common.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        toks = torch.arange(4, dtype=torch.int32)
        ctx1 = decoder.RunCtx("cpu", use_kernel="ref")
        c1 = decoder.init_cache(cfg, 4, 32, torch.float32, "cpu")
        ref, c1 = _decode(cfg, ctx1, params, c1, toks, 0)
        mesh = _mesh(shape, ("data", "seq", "model"))
        ctx8 = decoder.RunCtx("cpu", mesh=mesh, batch_axes=("data",),
                              use_kernel="ref", seq_axis="seq")
        blocks = shd.shard_params(cfg, params, mesh)
        c8 = decoder.init_cache(cfg, 4, 32, torch.float32, "cpu", mesh=mesh)
        got, c8 = _decode(cfg, ctx8, blocks, c8, toks, 0)
        nxt = got.argmax(-1).to(torch.int32)
        got2, c8 = _decode(cfg, ctx8, blocks, c8, nxt,
                           torch.ones(4, dtype=torch.int32))
        ref2, c1 = _decode(cfg, ctx1, params, c1,
                           ref.argmax(-1).to(torch.int32), 1)
        ring = next(layer["attn"] for layer in c8 if "attn" in layer)
        out[f"{tag}_got"], out[f"{tag}_ref"] = got2.numpy(), ref2.numpy()
        # three tokens at positions 2-4 over the same rings: each rank
        # attends its chunk and the chunks merge by their lse
        multi = (torch.arange(12, dtype=torch.int32).reshape(4, 3) * 7
                 % cfg.vocab_size)
        got3, c8 = decoder.multi_token_step(cfg, ctx8, blocks, c8, multi, 2)
        ref3, c1 = decoder.multi_token_step(cfg, ctx1, params, c1, multi, 2)
        out[f"{tag}_multi"], out[f"{tag}_multi_ref"] = got3.numpy(), \
            ref3.numpy()
        # a prefill on the mesh: the global logits, and each rank's block
        # of the prompt cache is its block of the single-device one
        batch = {"tokens": torch.arange(32, dtype=torch.int32).reshape(4, 8)
                 % cfg.vocab_size}
        got_p, cache_p = decoder.prefill(cfg, ctx8, blocks, batch)
        want_p, whole = decoder.prefill(cfg, ctx1, params, batch)
        specs = shd.cache_pspecs(cfg, mesh, whole, 4)
        out[f"{tag}_prefill"] = np.asarray([
            float((got_p - want_p).abs().max()),
            max(float((leaf - shd.local_shard(whole[i][m][k],
                                              specs[i][m][k], mesh))
                      .abs().max())
                for i, layer in enumerate(cache_p)
                for m, leaves in layer.items()
                for k, leaf in leaves.items())])
        out[f"{tag}_got1"], out[f"{tag}_ref1"] = got.numpy(), ref.numpy()
        out[f"{tag}_ring"] = np.asarray(next(iter(ring.values())).shape)
    return out


def _migrate_case(shape) -> dict:
    """Export / import a session between two KV stores on a seq mesh (the
    reference's test_seq_sharded_migrate_roundtrip on (1, 8, 1); on (2, 4,
    1) the slots are also cut over the data axis)."""
    from repro_torch.models import common, decoder
    from repro_torch.serve.kvcache import KVStore

    cfg = _f32("glm4-9b")
    mesh = _mesh(shape, ("data", "seq", "model"))
    ctx = decoder.RunCtx("cpu", mesh=mesh, batch_axes=("data",),
                         use_kernel="ref", seq_axis="seq")
    params = common.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    src = KVStore(cfg, 4, 64, torch.float32, device="cpu", mesh=mesh)
    dst = KVStore(cfg, 4, 64, torch.float32, device="cpu", mesh=mesh)
    s = src.alloc(42)
    tok = torch.zeros(4, dtype=torch.int32)
    pos = torch.zeros(4, dtype=torch.int32)
    for _ in range(3):
        logits, src.caches = _decode(cfg, ctx, params, src.caches, tok, pos)
        tok = logits.argmax(-1).to(torch.int32)
        pos = pos + 1
    s.length, s.last_token = 3, int(tok[s.slot])
    logits_src, _ = _decode(cfg, ctx, params, src.caches, tok, pos)
    blob = src.export_session(42)
    dst.alloc(7)                                  # force another slot
    s2 = dst.import_session(blob)
    tok2 = torch.zeros(4, dtype=torch.int32)
    tok2[s2.slot] = s.last_token
    logits_dst, _ = _decode(cfg, ctx, params, dst.caches, tok2,
                            torch.full((4,), 3, dtype=torch.int32))
    mamba = KVStore(_f32("mamba2-780m"), 4, 64, torch.float32, device="cpu",
                    mesh=mesh)
    ring = next(layer["attn"]["k"] for layer in dst.caches if "attn" in layer)
    return {"src": logits_src[s.slot].numpy(),
            "dst": logits_dst[s2.slot].numpy(),
            "slots": np.asarray([s.slot, s2.slot]),
            "seq_shards": np.asarray([src.seq_shards, blob["seq_shards"],
                                      mamba.seq_shards]),
            "ring": np.asarray(ring.shape),
            "nbytes": np.asarray([src.nbytes_session(),
                                  KVStore(cfg, 4, 64, torch.float32,
                                          device="cpu").nbytes_session()])}


def _train_pair(cfg, shape, names, batch, microbatches: int = 1,
                model_size: int = 1, **mesh_kw) -> dict:
    """One train step on one device and on a mesh, from the same params
    (``model_size``: the mesh's MoE experts in its chunked layout, which
    for tp 1 flattens in the unchunked layout's order).  The mesh's ranks
    hold their blocks, gathered whole after the step."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models import common, decoder
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step
    from repro_torch.train.tree import leaves

    params = common.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tcfg = TrainConfig(microbatches=microbatches)
    out = {}
    for tag, ctx in (
            ("one", decoder.RunCtx("cpu", use_kernel="ref")),
            ("mesh", decoder.RunCtx("cpu", mesh=_mesh(shape, names),
                                    batch_axes=("data",), use_kernel="ref",
                                    **mesh_kw))):
        p = copy.deepcopy(params)
        if tag == "mesh":
            if model_size > 1:
                p = _chunk_experts(p, model_size)
            p = shd.shard_params(cfg, p, ctx.mesh)
        p, _, m = make_train_step(cfg, ctx, tcfg)(p, opt.init(p), batch)
        if tag == "mesh":
            p = _gathered(cfg, p, ctx.mesh)
        out[f"{tag}_loss"] = np.asarray(float(m["loss"]))
        out[f"{tag}_params"] = torch.cat([t.reshape(-1)
                                          for t in leaves(p)]).numpy()
    return out


def _gathered(cfg, tree, mesh):
    """Every leaf of ``tree`` (parameters, or a state that holds them) that
    is this rank's block gathered whole over ``mesh``."""
    from repro_torch.dist import sharding as shd
    from repro_torch.train.tree import leaves_with_paths, unflatten

    spec = shd.param_spec_fn(cfg, mesh)
    return unflatten(tree, [shd.gather(t, spec(path, t), mesh)
                            for path, t in leaves_with_paths(tree)])


def _chunk_experts(params, model_size: int):
    """``params`` with every MoE layer's experts in the chunked layout of
    ``model_size``."""
    from repro_torch.models import moe

    for layer in params["layers"]:
        if "moe" in layer:
            we = layer["moe"]["experts"]
            chunks = moe.to_chunked(we["w_gate"][0], we["w_up"][0],
                                    we["w_down"][0], model_size)
            layer["moe"]["experts"] = dict(zip(("w_gate", "w_up", "w_down"),
                                               chunks))
    return params


def _lm_batch(cfg, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s),
                                             dtype=np.int32))
            for k in ("tokens", "labels")}


def sharded8(rank: int, world: int, inputs: str) -> dict:
    """Everything of tests/test_torch_sharded.py that needs 8 ranks."""
    from repro_torch.dist.sharding import make_plan_mesh
    from repro_torch.plan.score import score_moves
    from repro_torch.train.compression import compressed_psum

    inp = dict(np.load(inputs))
    out = {}
    mesh = _mesh((2, 4), ("data", "model"))
    out.update(_moe_cases(inp, mesh))
    out.update(_moe_grads(inp, mesh))
    # the int8 all-reduce over the 8 ranks, one gradient row each
    got, res = compressed_psum(_t(inp["psum_g"][rank]),
                               torch.zeros(inp["psum_g"].shape[1]))
    out["psum"], out["psum_res"] = got.numpy(), res.numpy()
    # the planner's scores, classes split over the plan mesh
    pm = make_plan_mesh()
    out["plan_mesh"] = np.asarray(pm.size())
    for co in (0.0, 0.5):
        out[f"scores_co{co}"] = score_moves(
            inp["rates"], inp["owner"], inp["fwd"], inp["move"], inp["cpu"],
            horizon_ms=50.0, min_frac=0.1, load_gain=0.3, co_gain=co,
            co_rates=inp["co_rates"], device="cpu", mesh=pm)
    out.update(_seq_decode_cases(rank))
    for shape in ((1, 8, 1), (2, 4, 1)):
        tag = "".join(map(str, shape))
        out.update({f"mig{tag}_{k}": v
                    for k, v in _migrate_case(shape).items()})
    cfg = _f32("glm4-9b")
    out.update({f"train42_{k}": v for k, v in _train_pair(
        cfg, (4, 2), ("data", "model"), _lm_batch(cfg, 8, 32, 0)).items()})
    return out


def train4(rank: int, world: int) -> dict:
    """The mesh train step on (4, 1), sequence-parallel attention (six
    heads on a four-rank model axis) on (1, 4), and mixtral's MoE layers
    on (2, 2) (experts chunked over the model axis, capacity factor 8:
    nothing drops), each against one device."""
    cfg = _f32("glm4-9b")
    out = {f"train41_{k}": v for k, v in _train_pair(
        cfg, (4, 1), ("data", "model"), _lm_batch(cfg, 8, 32, 0)).items()}
    six = dataclasses.replace(cfg, n_heads=6)
    out.update({f"seqpar_{k}": v for k, v in _train_pair(
        six, (1, 4), ("data", "model"), _lm_batch(six, 2, 32, 1)).items()})
    mix = _f32("mixtral-8x7b")
    out.update({f"moe22_{k}": v for k, v in _train_pair(
        mix, (2, 2), ("data", "model"), _lm_batch(mix, 4, 16, 2),
        model_size=2, capacity_factor=8.0).items()})
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_elastic.py: save on one world, restore on another
# ---------------------------------------------------------------------------

def _state(arch: str, model_size: int):
    from repro_torch.models import common
    from repro_torch.train import optimizer as opt

    cfg = _f32(arch)
    params = common.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                                model_size=model_size)
    return params, opt.init(params)


def _expert_specs(mesh):
    """The restore rule of a (data, model) mesh: expert chunks over the
    model axis (:func:`repro_torch.dist.sharding.param_pspecs`' rule for
    them), everything else whole."""
    from repro_torch.dist import comm

    msize = comm.size(mesh, "model")

    def spec(path, leaf):
        return ("model",) if "experts" in path and msize > 1 else ()
    return spec


def elastic_save(rank: int, world: int, ckpt: str) -> dict:
    """Four ranks take one mesh train step of mixtral (experts chunked over
    a model axis of 2, each rank holding its blocks); rank 0 commits the
    state, gathered whole.  Then ranks 2 and 3
    fail, and the survivors resume on the (1, 2) mesh they still make."""
    from repro_torch.models import decoder
    from repro_torch.train import checkpoint
    from repro_torch.train.elastic import resume_after_failure
    from repro_torch.train.train_step import make_train_step

    from repro_torch.dist import sharding as shd
    from repro_torch.train import optimizer as opt

    cfg = _f32("mixtral-8x7b")
    mesh = _mesh((2, 2), ("data", "model"))
    params = shd.shard_params(cfg, _state("mixtral-8x7b", 2)[0], mesh)
    ctx = decoder.RunCtx("cpu", mesh=mesh, use_kernel="ref",
                         capacity_factor=8.0)
    params, state, m = make_train_step(cfg, ctx)(
        params, opt.init(params), _lm_batch(cfg, 4, 16, 2))
    whole = _gathered(cfg, (params, state), mesh)
    if rank == 0:
        checkpoint.save(ckpt, 7, whole)
    dist.barrier()
    from repro_torch.train.tree import leaves

    out = {"saved": torch.cat([t.reshape(-1).float()
                               for t in leaves(whole)]).numpy()}
    if rank >= 2:                       # these hosts are lost
        return out
    like = _state("mixtral-8x7b", 2)
    got, step, mesh = resume_after_failure(ckpt, like, [0, 1],
                                           model_size=2)
    out["step"] = np.asarray(step)
    out["mesh"] = np.asarray([mesh.size(0), mesh.size(1)])
    out["restored"] = torch.cat([t.reshape(-1).float()
                                 for t in leaves(got)]).numpy()
    return out


def elastic_restore(rank: int, world: int, ckpt: str) -> dict:
    """A world of two restores the four-rank checkpoint onto a (1, 2) mesh:
    each rank keeps its expert chunk and every other leaf whole."""
    from repro_torch.train.elastic import resume_after_failure
    from repro_torch.train.tree import leaves, leaves_with_paths

    full = _state("mixtral-8x7b", 2)
    like = copy.deepcopy(full)
    like = _local_like(like, rank)
    got, step, mesh = resume_after_failure(ckpt, like, [0, 1], model_size=2,
                                           make_specs=_expert_specs)
    chunks = [t for p, t in leaves_with_paths(got) if "experts" in p]
    return {"step": np.asarray(step),
            "mesh": np.asarray([mesh.size(0), mesh.size(1)]),
            "restored": torch.cat([t.reshape(-1).float()
                                   for t in leaves(got)]).numpy(),
            "chunk_rows": np.asarray([c.shape[0] for c in chunks])}


def _local_like(tree, rank: int):
    """``tree`` with each global expert chunk stack cut to chunk ``rank``
    (the shapes a rank of a model axis of 2 holds)."""
    from repro_torch.train.tree import leaves_with_paths, unflatten

    pairs = leaves_with_paths(tree)
    return unflatten(tree, [t[rank:rank + 1].clone()
                            if "experts" in p and t.shape[0] == 2 else t
                            for p, t in pairs])


def seq_decode_cards(rank: int, world: int) -> dict:
    """glm4's smoke decode with its ring cut over two cards (a (1, 2, 1)
    mesh) against the single-card decode, both in f32 on the kernels."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import common, decoder

    dev = torch.device("cuda", rank)
    cfg = dataclasses.replace(_f32("glm4-9b"), n_heads=32, n_kv_heads=2,
                              head_dim=64, d_model=256)
    params = common.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                dev)
    mesh = init_device_mesh("cuda", (1, 2, 1),
                            mesh_dim_names=("data", "seq", "model"))
    out = {}
    for tag, ctx in (("ref", decoder.RunCtx(dev)),
                     ("got", decoder.RunCtx(dev, mesh=mesh,
                                            seq_axis="seq"))):
        caches = decoder.init_cache(cfg, 2, 128, torch.float32, dev,
                                    mesh=ctx.mesh)
        tok = torch.tensor([3, 5], dtype=torch.int32, device=dev)
        for pos in range(3):
            logits, caches = decoder.decode_step(cfg, ctx, params, caches,
                                                 tok, pos)
            tok = logits.argmax(-1).to(torch.int32)
        out[tag] = logits.cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_tp.py: tensor parallelism of the dense stack
# ---------------------------------------------------------------------------

def _nested(flat: dict, prefix: str) -> dict:
    """``{"a/b/c": array}`` entries under ``prefix`` -> a nested dict."""
    tree: dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


def _tp_case(inp: dict, tag: str, arch: str, shape, ckpt: str) -> dict:
    """One arch on one (data, model) mesh, each rank holding its blocks:
    forward, prefill + two decode steps, one train step, the parameter
    bytes and a checkpoint round trip."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models import common, decoder
    from repro_torch.train import checkpoint
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import leaves, leaves_with_paths

    cfg = _f32(arch)
    mesh = _mesh(shape, ("data", "model"))
    whole = common.params_from_numpy(cfg, _nested(inp, f"{tag}|params|"),
                                     "cpu")
    params = shd.shard_params(cfg, whole, mesh)
    ctx = decoder.RunCtx("cpu", mesh=mesh, batch_axes=("data",),
                         use_kernel="ref", capacity_factor=8.0)
    batch = {k.split("|")[2]: _t(v) for k, v in inp.items()
             if k.startswith(f"{tag}|batch|")}
    out = {}
    fwd = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        out["fwd"] = decoder.forward(cfg, ctx, params, fwd)
    if cfg.causal:
        b, s = next(iter(fwd.values())).shape[:2]
        logits, cache = decoder.prefill(cfg, ctx, params, fwd)
        out["prefill"] = logits
        ring = decoder.into_ring(decoder.init_cache(
            cfg, b, s + 4, torch.float32, "cpu", mesh=mesh), cache)
        for i, tok in enumerate(_t(inp[f"{tag}|dec"])):
            out[f"dec{i}"], ring = decoder.decode_step(cfg, ctx, params,
                                                       ring, tok, s + i)
    specs = shd.param_spec_fn(cfg, mesh)
    whole_bytes = sum(t.numel() * t.element_size() for t in leaves(whole))
    local_bytes = leaves(shd._map_tree(lambda _, sh: 4 * int(np.prod(sh)),
                                       shd.local_param_shapes(cfg, mesh)))
    out["bytes"] = np.asarray([
        sum(t.numel() * t.element_size() for t in leaves(params)),
        sum(local_bytes), whole_bytes,
        sum(1 for path, t in leaves_with_paths(params) if specs(path, t))])
    state = opt.init(params)
    params, state, m = make_train_step(cfg, ctx)(params, state, batch)
    out["loss"] = m["loss"]
    out["trained"] = torch.cat([shd.gather(t, specs(path, t), mesh)
                                .reshape(-1)
                                for path, t in leaves_with_paths(params)])
    # the blocks saved whole by the world, restored as this rank's blocks
    checkpoint.save(ckpt, 1, (params, state), mesh=mesh, specs=specs)
    dist.barrier()
    back, _ = checkpoint.restore(ckpt, (params, state), mesh=mesh,
                                 specs=specs)
    out["restored"] = np.asarray(max(
        float((a - b).abs().max()) for a, b in zip(leaves(back),
                                                   leaves((params, state)))))
    dist.barrier()
    return {f"{tag}|{k}": v.detach().numpy() if isinstance(v, torch.Tensor)
            else v for k, v in out.items()}


def tp8(rank: int, world: int, inputs: str, cases: list, ckpt: str
        ) -> dict:
    """Every case of tests/test_torch_tp.py in one 8-rank world."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models import common
    from repro_torch.train.tree import leaves

    inp = dict(np.load(inputs))
    out = {}
    for tag, arch, shape in cases:
        out.update(_tp_case(inp, tag, arch, tuple(shape), f"{ckpt}/{tag}"))
    # init_params(mesh=) draws the blocks of the whole tree's draw
    for arch in ("glm4-9b", "deepseek-v2-236b"):
        cfg, mesh = _f32(arch), _mesh((2, 4), ("data", "model"))
        got = common.init_params(cfg, torch.Generator().manual_seed(5),
                                 "cpu", mesh=mesh)
        want = shd.shard_params(cfg, common.init_params(
            cfg, torch.Generator().manual_seed(5), "cpu", model_size=4),
            mesh)
        out[f"init|{arch}"] = np.asarray([
            len(leaves(got)) == len(leaves(want)) and all(
                torch.equal(a, b) for a, b in zip(leaves(got),
                                                  leaves(want)))])
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_dryrun.py: the counting pass in a world of real ranks
# ---------------------------------------------------------------------------

def count_cells(cells: list, shape, fake: bool = False,
                serve: list = ()) -> dict:
    """Each ``(arch, kind, seq, batch)`` smoke cell's step on this rank of
    a ``(data, model)`` mesh under the dry run's counting pass (on zeros
    of real tensors, or of fake ones): its dot FLOPs, its argument bytes
    and its collective records (JSON); and each ``(arch, batch, prompt,
    ring)`` of ``serve`` through ``dryrun.count_serve``: its dot FLOPs
    and the records of its prefill and first decode step."""
    import contextlib
    import json

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun

    mesh = _mesh(shape, ("data", "model"))
    out = {}
    for arch, kind, seq, batch in cells:
        spec = ShapeSpec(f"smoke_{kind}", seq, batch, kind)
        with FakeTensorMode() if fake else contextlib.nullcontext():
            counts, arg = dryrun.count_cell(get_smoke_config(arch), spec,
                                            mesh)
        tag = f"{arch}|{kind}"
        out[f"{tag}|dot"] = np.asarray(counts.dot_flops)
        out[f"{tag}|args"] = np.asarray(arg)
        out[f"{tag}|records"] = np.asarray(json.dumps(
            [[op, str(dt), list(sh), g] for op, dt, sh, g in counts.records]))
    for arch, batch, prompt, ring in serve:
        with FakeTensorMode() if fake else contextlib.nullcontext():
            counts, run = dryrun.count_serve(get_smoke_config(arch), mesh,
                                             batch, prompt, ring)
        out[f"serve|{arch}|dot"] = np.asarray(counts.dot_flops)
        out[f"serve|{arch}|records"] = np.asarray(json.dumps(
            [run["prefill_records"], run["decode_records"]]))
    return out


def count4(rank: int, world: int, cells: list, serve: list = ()) -> dict:
    """:func:`count_cells` on a (1, 4) mesh of real ranks."""
    return count_cells(cells, (1, 4), serve=serve)
