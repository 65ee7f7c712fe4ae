"""The rank bodies of ``tests/test_torch_tp.py``: spawned rank processes
import this module by name, so it imports ``torch`` and the port only (no
JAX). Every body ends by gathering each rank's results, so rank 0's return
value (what ``spawn_tp`` hands back) holds all of them."""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced
from repro_torch.core import plan as plan_mod
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch.serve import ContinuousBatchingEngine
from repro_torch.launch.steps import (make_prefill_step, make_tp_chunk_prefill_step,
                                      make_tp_prefill_step)
from repro_torch.layers.linear import linear_apply
from repro_torch.models.cache import init_cache
from repro_torch.models.quant import quantize_params
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.scheduler import Request
from repro_torch.sharding.tp import shard_quantized, shard_quantized_all

ARCH = "granite-3-8b"
# the reference test's workload (tests/test_sharding_serving.py): more
# requests than slots, so slots are evicted and readmitted
LENS = [5, 9, 13, 7, 11]
GEN = 6
N_SLOTS = 2
MAX_LEN = 20  # max(LENS) + GEN, rounded up to whole pages of 4
#: the engine cases: policy keywords, engine keywords
CASES = {
    "dense": ({}, {}),
    "chunked": ({}, {"prefill_chunk": 4}),
    "paged": ({}, {"page_size": 4, "prefill_chunk": 4}),
    "detect": ({"integrity": "detect"}, {}),
}


def config():
    """Reduced granite-3-8b with 4 KV heads, so they divide at P=4."""
    return dataclasses.replace(get_reduced(ARCH), n_kv_heads=4)


def policy(**kw) -> PrecisionPolicy:
    return PrecisionPolicy.uniform(8, 8, level="bitplane", variant="booth", **kw)


def requests(cfg, cls=Request) -> list:
    rng = np.random.default_rng(0)
    return [cls(rid=i, tokens=rng.integers(0, cfg.vocab_size, (s,)), max_new_tokens=GEN,
                temperature=0.0, arrival_step=i * 2)
            for i, s in enumerate(LENS)]


def serve(cfg, params, case: str, model_parallel: int = 1, flip=None) -> dict:
    """Serve the workload in engine case ``case``: the tokens (lists), the
    integrity counts and the per-device plane bytes. ``flip(engine)`` runs
    between load and serving."""
    pol_kw, eng_kw = CASES[case]
    engine = ContinuousBatchingEngine(cfg, params, policy(**pol_kw), n_slots=N_SLOTS,
                                      max_len=MAX_LEN, device="cpu",
                                      model_parallel=model_parallel, **eng_kw)
    if flip is not None:
        flip(engine)
    results, stats = engine.run(requests(cfg))
    return {"tokens": {rid: t.tolist() for rid, t in results.items()},
            "failed": stats["failed"], "integrity": stats.get("integrity"),
            "plane_bytes": engine.plane_cache_bytes_per_device()}


def flip_planes(engine) -> None:
    """On rank 1 only: flip bit 0 of one raw plane value of the first
    layer's o_proj (the host route reads the raw planes, so the ABFT check
    sees it; the at-rest fingerprint sees it too)."""
    if dist.get_rank() == 1:
        planes = engine.q_params["layers"][0]["attn"]["o_proj"]["w_planes"].planes
        planes.view(-1)[3] ^= 1


def _linear_cases(tp) -> dict:
    """Row-, column- and vocab-parallel ``linear_apply`` on this rank
    against the single-device call (bf16 outputs as int16 bit patterns)."""
    gen = torch.Generator().manual_seed(3)
    d_in, d_out = 64, 48
    w = (torch.randn((d_in, d_out), generator=gen) * 0.1).to(torch.bfloat16)
    x = torch.randn((2, 3, d_in), generator=gen).to(torch.bfloat16)
    xf = torch.randn((2, 3, d_in), generator=gen)  # an unrounded x_f32
    bias = torch.randn((d_out,), generator=gen) * 0.05
    pol = policy()
    out = {}
    for path, name, kw in (("mlp/down_proj", "mlp/down_proj", dict(bias=bias, activation="silu")),
                           ("mlp/down_proj", "mlp/down_proj", dict(x_f32=xf)),
                           ("attn/q_proj", "attn/q_proj", dict(activation="gelu")),
                           ("lm_head/head", "lm_head", {})):
        tree = {}
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node["w"] = w

        def leaf(t):
            for part in path.split("/"):
                t = t[part]
            return t

        ref = linear_apply(leaf(quantize_params(tree, pol, cfg=None, plane_cache=True)), x,
                           name=name, policy=pol, **kw)
        local = leaf(shard_quantized(tree, pol, tp, cfg=None))
        role_row = name.endswith("down_proj")
        xs = x.chunk(tp.size, dim=-1)[tp.rank] if role_row else x
        if "x_f32" in kw:
            kw = dict(kw, x_f32=kw["x_f32"].chunk(tp.size, dim=-1)[tp.rank])
        with tp.scope():
            got = linear_apply(local, xs, name=name, policy=pol, **kw)
        if name == "attn/q_proj":  # column-parallel: this rank's columns
            ref = ref.chunk(tp.size, dim=-1)[tp.rank]
        out[f"{name} {sorted(kw)}"] = (got.view(torch.int16).tolist(),
                                       ref.view(torch.int16).tolist())
    return out


def _prefills(tp, cfg, params) -> list:
    """The last logits of a 13-token prompt (as int16 bit patterns): the
    single-device prefill, the tensor-parallel one, and two chunks (6 + 7
    tokens) through the tensor-parallel chunk step."""
    pol = policy()
    toks = torch.as_tensor(requests(cfg)[2].tokens)[None, :]
    single, _ = make_prefill_step(cfg, pol, max_len=MAX_LEN)(
        quantize_params(params, pol, cfg=cfg, plane_cache=True), toks)
    q = shard_quantized(params, pol, tp, cfg=cfg)
    whole, _ = make_tp_prefill_step(cfg, tp, pol, max_len=MAX_LEN)(q, toks)
    chunk = make_tp_chunk_prefill_step(cfg, tp, pol)
    scratch = init_cache(tp.local_config(cfg), 1, MAX_LEN, cfg.dtype)
    _, scratch = chunk(q, scratch, toks[:, :6])
    last, _ = chunk(q, scratch, toks[:, 6:])
    return [t.view(torch.int16).tolist() for t in (single, whole, last)]


def _same(a, b) -> bool:
    """Two trees hold the same leaves, bit for bit (plane caches by field)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


def _own_shards(tp, cfg, params) -> dict:
    """This rank's ``shard_quantized`` (row scales and compaction's kept
    planes through the all-reduces) against ``shard_quantized_all``'s
    element for this rank (every slice in one process)."""
    out = {}
    for mode, kw, vb in (("off", {}, None), ("compact", {"sparsity": "compact"}, 4)):
        pol = policy(**kw)
        own = shard_quantized(params, pol, tp, cfg=cfg, value_bits=vb)
        out[mode] = _same(own, shard_quantized_all(params, pol, tp.size, cfg=cfg,
                                                   value_bits=vb)[tp.rank])
    return out


def _shard_keys() -> list:
    return sorted({(k.m, k.k, k.n, k.shard, k.has_epilogue)
                   for k in (p.key for p in plan_mod.DEFAULT_REGISTRY.plans())},
                  key=repr)


def rank_p2(tp, device, tree) -> list:
    """P=2: the linear cases, the rank's own shards, every engine case,
    detect with a flipped bit on rank 1, and the plan keys this rank
    resolved."""
    cfg = config()
    params = params_from_numpy(cfg, tree, device=device)
    out = {"rank": tp.rank, "linear": _linear_cases(tp), "prefills": _prefills(tp, cfg, params),
           "own_shards": _own_shards(tp, cfg, params)}
    plan_mod.DEFAULT_REGISTRY.clear()  # the engines' plans alone below
    out["cases"] = {case: serve(cfg, params, case, tp.size) for case in CASES}
    out["flipped"] = serve(cfg, params, "detect", tp.size, flip=flip_planes)
    out["plan_keys"] = _shard_keys()
    every = [None] * tp.size
    dist.all_gather_object(every, out)
    return every


def rank_p4(tp, device, tree) -> list:
    """P=4: the dense engine case."""
    cfg = config()
    out = {"rank": tp.rank, "dense": serve(cfg, params_from_numpy(cfg, tree, device=device),
                                           "dense", tp.size)}
    every = [None] * tp.size
    dist.all_gather_object(every, out)
    return every
