"""The rank bodies of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_families.py``: spawned rank processes import this
module by name, so it imports ``torch`` and the port only (no JAX). Every
body ends by gathering each rank's results, so rank 0's return value (what
``spawn_ranks`` hands back) holds all of them."""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced
from repro_torch.core import plan as plan_mod
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import fold
from repro_torch.launch import sampling
from repro_torch.launch.inputs import make_batch
from repro_torch.launch.mesh import tp_context
from repro_torch.launch.serve import ContinuousBatchingEngine
from repro_torch.launch.steps import (make_cb_decode_step, make_prefill_step,
                                      make_tp_cb_decode_step, make_tp_chunk_prefill_step,
                                      make_tp_prefill_step)
from repro_torch.layers.linear import linear_apply
from repro_torch.models.cache import init_cache
from repro_torch.models.quant import map_linears, quantize_params
from repro_torch.models.transformer import init_params, params_from_numpy
from repro_torch.runtime.autopilot import AutopilotPolicy
from repro_torch.runtime.scheduler import Request
from repro_torch.sharding.tp import (load_shard, shard_quantized, shard_quantized_all,
                                     shard_source)

ARCH = "granite-3-8b"
# the reference test's workload (tests/test_sharding_serving.py): more
# requests than slots, so slots are evicted and readmitted
LENS = [5, 9, 13, 7, 11]
GEN = 6
N_SLOTS = 2
MAX_LEN = 20  # max(LENS) + GEN, rounded up to whole pages of 4
#: the engine cases: policy keywords, engine keywords. "scrub" runs with a
#: plane bit flipped on rank 1 (single device: none); "autopilot" on the
#: burst (``requests(burst=True)``); "autotune" cold on a fresh plan store,
#: then warm from it; "head" keeps the vocab head dense
CASES = {
    "dense": ({}, {}),
    "chunked": ({}, {"prefill_chunk": 4}),
    "paged": ({}, {"page_size": 4, "prefill_chunk": 4}),
    "detect": ({"integrity": "detect"}, {}),
    "scrub": ({"integrity": "scrub"}, {}),
    "autopilot": ({}, {"autopilot": AutopilotPolicy(sla_queue_steps=2, shadow_frac=0.5)}),
    "autotune": ({}, {"autotune": True}),
    "head": ({"keep_dense": ("lm_head", "head")}, {}),
}
#: the cases served at P=4 too (the others at P=2 alone)
P4_CASES = ("dense", "scrub", "autopilot", "autotune", "head")


def config():
    """Reduced granite-3-8b with 4 KV heads, so they divide at P=4."""
    return dataclasses.replace(get_reduced(ARCH), n_kv_heads=4)


def policy(**kw) -> PrecisionPolicy:
    return PrecisionPolicy.uniform(8, 8, level="bitplane", variant="booth", **kw)


def requests(cfg, cls=Request, burst: bool = False) -> list:
    """The workload; ``burst``: every request arrives at step 0 and every
    other one wants 3 tokens fewer, so the autopilot's queue SLA degrades
    the tier and slots of two tiers decode side by side."""
    rng = np.random.default_rng(0)
    return [cls(rid=i, tokens=rng.integers(0, cfg.vocab_size, (s,)),
                max_new_tokens=GEN - 3 * (i % 2) if burst else GEN,
                temperature=0.0, arrival_step=0 if burst else i * 2)
            for i, s in enumerate(LENS)]


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def _run(engine, cfg, case: str) -> dict:
    results, stats = engine.run(requests(cfg, burst=case == "autopilot"))
    out = {"tokens": {rid: t.tolist() for rid, t in results.items()},
           "failed": stats["failed"], "integrity": stats.get("integrity"),
           "plans": stats["plans"], "plane_bytes": engine.plane_cache_bytes_per_device()}
    if "autopilot" in stats:
        ap = stats["autopilot"]
        out["autopilot"] = {k: ap[k] for k in ("switches", "request_tiers", "tier_tokens",
                                               "mixed_steps", "shadow_probes", "shed")}
    return out


def _tuned_tiles() -> list:
    return sorted((repr(p.key), (p.bm, p.bn, p.bk, p.k_split))
                  for p in plan_mod.DEFAULT_REGISTRY.plans() if p.tuned)


def serve(cfg, params, case: str, model_parallel: int = 1, flip=None,
          store_dir=None) -> dict:
    """Serve the workload in engine case ``case``: the tokens (lists), the
    integrity counts, the plan counters and the per-device plane bytes.
    ``flip(engine)`` runs between load and serving. Scrub adds whether the
    served tree's fingerprint is the load-time one after the run and the
    bytes of the retained source; autotune serves cold on a fresh store in
    ``store_dir``, then, the tuner detached, warm from it (the tiles tuned,
    the files in ``store_dir`` and whether this rank's tuner keeps the
    store)."""
    pol_kw, eng_kw = CASES[case]
    if case == "autotune":
        eng_kw = dict(eng_kw, plan_store_path=os.path.join(store_dir, "plans.json"))
        # every plan resolves through the tuner (an untuned plan of an
        # earlier engine would be a registry hit)
        plan_mod.DEFAULT_REGISTRY.attach_tuner(None)
        plan_mod.DEFAULT_REGISTRY.clear()
    engine = ContinuousBatchingEngine(cfg, params, policy(**pol_kw), n_slots=N_SLOTS,
                                      max_len=MAX_LEN, device="cpu",
                                      model_parallel=model_parallel, **eng_kw)
    if flip is not None:
        flip(engine)
    out = _run(engine, cfg, case)
    if case == "scrub":
        out["fingerprint_restored"] = int(fold.tree_fold(engine.q_params)) == engine._params_ref
        out["source_bytes"] = _tree_bytes(engine._src_params)
    if case == "autotune":
        inner = getattr(engine.autotuner, "tuner", engine.autotuner)
        out["keeps_store"] = getattr(inner, "store", None) is not None
        out["tiles"] = _tuned_tiles()
        plan_mod.DEFAULT_REGISTRY.attach_tuner(None)  # warm: a fresh tuner on the store
        plan_mod.DEFAULT_REGISTRY.clear()
        engine = ContinuousBatchingEngine(cfg, params, policy(**pol_kw), n_slots=N_SLOTS,
                                          max_len=MAX_LEN, device="cpu",
                                          model_parallel=model_parallel, **eng_kw)
        out["warm"] = _run(engine, cfg, case)
        out["warm_tiles"] = _tuned_tiles()
        out["store_files"] = sorted(os.listdir(store_dir))
        plan_mod.DEFAULT_REGISTRY.attach_tuner(None)
    return out


def source_bytes_wanted(params, size: int, cfg) -> int:
    """The bytes a rank's scrub source holds: every linear's 1/``size``
    slice (a row slice with its float32 column maxima), every other leaf
    whole."""
    total = [_tree_bytes(params)]

    def one(node, path):
        w = node["w"]
        total[0] -= w.numel() * w.element_size() * (size - 1) // size
        if path.rsplit("/", 1)[-1] in ("o_proj", "down_proj"):
            total[0] += w.shape[-1] * 4
        return node

    map_linears(params, cfg, one)
    return total[0]


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


#: the loader's cases: (reduced arch, compaction); compaction runs at
#: value_bits=4, whose top planes are dead
LOADER_ARCHS = ("granite-3-8b", "deepseek-coder-33b")


def _loader(tp) -> dict:
    """``load_shard`` (each part drawn, sliced and quantized at once)
    against ``shard_quantized_all`` of the whole drawn tree, element for
    this rank, leaf for leaf; with its source, the rebuild from that source
    (``shard_source``) against the shard too."""
    out = {}
    for arch in LOADER_ARCHS:
        cfg = get_reduced(arch)
        for compact in (False, True):
            pol = policy(sparsity="compact") if compact else policy()
            vb = 4 if compact else None
            shard, src = load_shard(cfg, torch.Generator().manual_seed(7), pol, tp, device="cpu",
                                    value_bits=vb, with_source=True)
            whole = init_params(cfg, torch.Generator().manual_seed(7))
            want = shard_quantized_all(whole, pol, tp.size, cfg=cfg, value_bits=vb)[tp.rank]
            rebuilt = shard_source(src, pol, tp, cfg=cfg, value_bits=vb)
            out[f"{arch} compact={compact}"] = {"loaded": _same(shard, want),
                                                "rebuilt": _same(rebuilt, want)}
    return out


def _defect_i(tp, cfg, params) -> dict:
    """The engine's refusal of each dense column- or row-parallel
    projection (reference defect I): the messages."""
    out = {}
    for name in ("q_proj", "gate_proj", "o_proj"):
        try:
            ContinuousBatchingEngine(cfg, params, policy(keep_dense=(name,)), n_slots=N_SLOTS,
                                     max_len=MAX_LEN, device="cpu", model_parallel=tp.size)
            out[name] = None
        except ValueError as err:
            out[name] = str(err)
    return out


def rank_p2(backend, device, tree, store_dir) -> list:
    """P=2: the linear cases, the rank's own shards, the loader, every
    engine case (scrub with a flipped bit on rank 1), detect with a flipped
    bit on rank 1, defect I, and the plan keys this rank resolved."""
    tp = tp_context()
    cfg = config()
    params = params_from_numpy(cfg, tree, device=device)
    out = {"rank": tp.rank, "linear": _linear_cases(tp), "prefills": _prefills(tp, cfg, params),
           "own_shards": _own_shards(tp, cfg, params), "loader": _loader(tp),
           "defect_i": _defect_i(tp, cfg, params),
           "source_bytes_wanted": source_bytes_wanted(params, tp.size, cfg)}
    plan_mod.DEFAULT_REGISTRY.clear()  # the engines' plans alone below
    out["cases"] = {case: serve(cfg, params, case, tp.size,
                                flip=flip_planes if case == "scrub" else None,
                                store_dir=store_dir)
                    for case in CASES if case != "autotune"}
    out["plan_keys"] = _shard_keys()
    out["flipped"] = serve(cfg, params, "detect", tp.size, flip=flip_planes)
    out["cases"]["autotune"] = serve(cfg, params, "autotune", tp.size, store_dir=store_dir)
    every = [None] * tp.size
    dist.all_gather_object(every, out)
    return every


def rank_p4(backend, device, tree, store_dir) -> list:
    """P=4: the loader and the engine cases of ``P4_CASES`` (scrub with a
    flipped bit on rank 1)."""
    tp = tp_context()
    cfg = config()
    params = params_from_numpy(cfg, tree, device=device)
    out = {"rank": tp.rank, "loader": _loader(tp),
           "source_bytes_wanted": source_bytes_wanted(params, tp.size, cfg),
           "cases": {case: serve(cfg, params, case, tp.size,
                                 flip=flip_planes if case == "scrub" else None,
                                 store_dir=store_dir)
                     for case in P4_CASES}}
    every = [None] * tp.size
    dist.all_gather_object(every, out)
    return every


# -- the families (tests/test_torch_tp_families.py) ---------------------------

#: the reference's serving policy of the MoE and VLM architectures
ARCH_KEEP = ("frontend", "router")
#: name -> (reduced arch, config changes, policy keywords, prompt lengths):
#: the SSD scan takes multiples of 8; recurrentgemma's reduced config has
#: one KV head, two here so they divide at P=2
FAMILIES = {
    "mamba2": ("mamba2-1.3b", {}, {}, (8, 16, 8, 16, 8)),
    "rgemma": ("recurrentgemma-2b", {"n_kv_heads": 2}, {}, tuple(LENS)),
    "qwen3moe": ("qwen3-moe-235b-a22b", {}, {"keep_dense": ARCH_KEEP}, tuple(LENS)),
    "scout": ("llama4-scout-17b-a16e", {}, {"keep_dense": ARCH_KEEP}, tuple(LENS)),
    "internvl2": ("internvl2-2b", {}, {"keep_dense": ARCH_KEEP}, tuple(LENS)),
}
#: the families whose heads divide at P=4
FAMILIES_P4 = ("mamba2",)
#: internvl2's image prefix: batch, text tokens, decode steps, batch seed
VLM_BATCH, VLM_TEXT, VLM_STEPS, VLM_SEED = 2, 6, 4, 3


def family_config(name: str):
    arch, changes, _, _ = FAMILIES[name]
    return dataclasses.replace(get_reduced(arch), **changes)


def family_policy(name: str) -> PrecisionPolicy:
    return policy(**FAMILIES[name][2])


def family_requests(name: str, vocab: int, cls=Request) -> list:
    rng = np.random.default_rng(1)
    return [cls(rid=i, tokens=rng.integers(0, vocab, (s,)), max_new_tokens=GEN,
                temperature=0.0, arrival_step=2 * i)
            for i, s in enumerate(FAMILIES[name][3])]


def serve_family(name: str, params, model_parallel: int = 1) -> dict:
    """The family's workload through the engine (2 slots): the tokens."""
    cfg = family_config(name)
    engine = ContinuousBatchingEngine(cfg, params, family_policy(name), n_slots=N_SLOTS,
                                      max_len=max(FAMILIES[name][3]) + GEN, device="cpu",
                                      model_parallel=model_parallel)
    results, stats = engine.run(family_requests(name, cfg.vocab_size))
    assert not stats["failed"], stats["failed"]
    return {rid: t.tolist() for rid, t in results.items()}


def vlm_batch(cfg) -> dict:
    return make_batch(cfg, VLM_BATCH, cfg.num_patches + VLM_TEXT, "prefill",
                      np.random.default_rng(VLM_SEED), device="cpu")


def vlm_prefix(params, tp=None) -> dict:
    """internvl2 with its image prefix: the prefill of ``vlm_batch`` (the
    patches through the dense front end, then the text) and ``VLM_STEPS``
    greedy decode steps, tensor-parallel under ``tp`` (its shard of
    ``params``) or on one device. Returns the prefill's last logits as
    int16 bit patterns and the tokens, first the prefill's."""
    cfg, pol = family_config("internvl2"), family_policy("internvl2")
    max_len = cfg.num_patches + VLM_TEXT + VLM_STEPS + 1
    if tp is None:
        q = quantize_params(params, pol, cfg=cfg, plane_cache=True)
        prefill = make_prefill_step(cfg, pol, max_len=max_len, kv_quant=True)
        step = make_cb_decode_step(cfg, pol)
    else:
        q = shard_quantized(params, pol, tp, cfg=cfg)
        prefill = make_tp_prefill_step(cfg, tp, pol, max_len=max_len, kv_quant=True)
        step = make_tp_cb_decode_step(cfg, tp, pol)
    logits, cache = prefill(q, vlm_batch(cfg))
    tok = sampling.greedy(sampling.mask_vocab(logits, cfg.vocab_size)).to(torch.int32)[:, None]
    temps = torch.zeros((VLM_BATCH,), dtype=torch.float32)
    toks = [tok[:, 0].tolist()]
    for _ in range(VLM_STEPS):
        tok, cache = step(q, cache, tok, temps, None)[:2]
        toks.append(tok[:, 0].tolist())
    return {"logits": logits.view(torch.int16).tolist(), "tokens": toks}


def rank_families(backend, device, trees) -> list:
    """Every family in ``trees`` (name -> the reference's numpy tree)
    through the engine at this group's size; at P=2 also internvl2's image
    prefix."""
    tp = tp_context()
    out = {"rank": tp.rank, "tokens": {}}
    for name, tree in trees.items():
        params = params_from_numpy(family_config(name), tree, device=device)
        out["tokens"][name] = serve_family(name, params, tp.size)
        if name == "internvl2":
            out["vlm"] = vlm_prefix(params, tp)
    every = [None] * tp.size
    dist.all_gather_object(every, out)
    return every


# -- deepseek-coder-33b across cards (tests/test_torch_cuda.py) --------------

#: the chip smoke's workload: prompts, new tokens, slots, arrivals two steps
#: apart, the 8 -> 4 switch at decode step 8
SMOKE_LENS, SMOKE_GEN, SMOKE_SLOTS, SMOKE_SWITCH = (32, 64, 128, 256), 16, 4, {8: 4}


def rank_deepseek(backend, device, n_layers: int) -> dict:
    """deepseek-coder-33b at full width and ``n_layers`` layers on this
    group (one rank: the single-device engine), drawn from seed 0 on the
    card (``SeededParams``: a rank loads its shard layer by layer), served
    over the chip smoke's workload with CUDA graphs and int8 KV. Returns
    the tokens and each rank's card peak, card resident and host peak RSS
    (GiB)."""
    tp = tp_context()
    import resource

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import SeededParams

    cfg = dataclasses.replace(get_config("deepseek-coder-33b"), n_layers=n_layers)
    engine = ContinuousBatchingEngine(cfg, SeededParams(0), policy(), n_slots=SMOKE_SLOTS,
                                      max_len=max(SMOKE_LENS) + SMOKE_GEN, device=device,
                                      model_parallel=tp.size)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, (s,)),
                    max_new_tokens=SMOKE_GEN, arrival_step=2 * i)
            for i, s in enumerate(SMOKE_LENS)]
    results, stats = engine.run(reqs, precision_schedule=SMOKE_SWITCH)
    mine = (torch.cuda.max_memory_allocated(device) / 2**30,
            torch.cuda.memory_allocated(device) / 2**30,
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
    every = [None] * tp.size
    dist.all_gather_object(every, mine)
    return {"tokens": {rid: t.tolist() for rid, t in results.items()}, "failed": stats["failed"],
            "switches": stats["precision_switches"], "memory": every,
            "card": torch.cuda.get_device_name(device)}
