"""The compiled serving steps, on the CPU: what the engine captures as one
CUDA graph per precision on the card, run here without capture.

* The static-buffer decode step (``serve._decode_body``, the function the
  graph captures, writing its cache and tokens in place) gives the JAX
  reference's compiled decode logits and greedy tokens bit for bit, dense
  and paged, at both levels, across an 8 -> 4 bit switch, with one slot
  running past its extent (a paged slot past its table's span).
* The in-place dense append equals the functional ``torch.where`` append
  it replaced, a slot at the extent included.
* One decode step of every route reads nothing back to the host and builds
  no tensor from host data (a ``TorchDispatchMode`` watches it): the card's
  routes with their kernels stubbed (the kernels run only on the card),
  greedy and sampled.
* The fold kernel's host model equals the port's and the reference's
  fingerprints, a flipped bit included.
* A stub runner that replays like a graph (the step reruns, the Python
  counters are put back) gives the eager run's route calls, tokens and
  alarms through the engine's per-replay tally.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core import integrity as jinteg
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch import sampling as jsampling
from repro.models import paging as jpaging
from repro.models.cache import cache_slot_checksums as jslot_checksums
from repro.models.cache import init_cache as jinit_cache
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jinit
from repro_torch.configs import get_reduced as tget
from repro_torch.core import integrity as tinteg
from repro_torch.core import plan as plan_mod
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.kernels import fold
from repro_torch.launch import sampling, serve
from repro_torch.launch.steps import make_cb_decode_step
from repro_torch.layers import attention
from repro_torch.models import paging as tpaging
from repro_torch.models.cache import cache_slot_checksums as tslot_checksums
from repro_torch.models.cache import init_cache as tinit_cache
from repro_torch.models.cache import quantize_kv
from repro_torch.models.quant import quantize_params as tquantize_params
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.scheduler import Request as TRequest

from _torch_parity import (
    StubRunner,
    Watch,
    stub_kernels,
    t2n,
    to_numpy_tree,
    weight_planes_to_jax,
)

N_SLOTS = 2
MAX_LEN = 8
PAGE = 4
START_LENS = (0, 3)  # slot 1 reaches the extent after 5 steps and writes nothing after
STEPS = 7
SWITCH_AT = 3

_PARAMS: dict = {}


def _params(arch):
    """(JAX params, port params) from one JAX init per module."""
    if arch not in _PARAMS:
        jp = jax.jit(lambda k: jinit(jget(arch), k))(jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, params_from_numpy(tget(arch), to_numpy_tree(jp), device="cpu"))
    return _PARAMS[arch]


def _to_jax_tree(tq):
    """The port's quantized tree in the reference's layout (layers stacked
    under ``periods/b0_dense``); the trees are held equal by
    test_torch_serving.py, so this spares the reference's eager
    quantization."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            return jnp.asarray(t2n(node), dtype=jnp.bfloat16 if node.dtype == torch.bfloat16
                               else None)
        return weight_planes_to_jax(node)

    out = {k: conv(v) for k, v in tq.items() if k != "layers"}
    layers = [conv(blk) for blk in tq["layers"]]
    out["periods"] = {"b0_dense": jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *layers)}
    return out


def _caches(cfg, jcfg, paged):
    """Equal (JAX, port) caches: slot lengths START_LENS over zero KV; paged
    with pages 1-2 for slot 0 and 3-4 for slot 1."""
    lens = np.asarray(START_LENS, np.int32)
    if paged:
        jc = jpaging.paged_init_cache(jcfg, N_SLOTS, MAX_LEN, PAGE, 6)
        tc = tpaging.paged_init_cache(cfg, N_SLOTS, MAX_LEN, PAGE, 6, device="cpu")
        tables = np.asarray([[1, 2], [3, 4]], np.int32)
    else:
        jc = jinit_cache(jcfg, N_SLOTS, MAX_LEN, kv_quant=True)
        tc = tinit_cache(cfg, N_SLOTS, MAX_LEN, kv_quant=True, device="cpu")
    blk = dict(jc["periods"]["b0_dense"])
    n_layers = cfg.n_layers
    blk["len"] = jnp.asarray(np.broadcast_to(lens, (n_layers, N_SLOTS)))
    if paged:
        blk["block_table"] = jnp.asarray(np.broadcast_to(tables, (n_layers,) + tables.shape))
    jc = dict(jc, step=jnp.asarray(lens), periods={"b0_dense": blk})
    tc["step"].copy_(torch.from_numpy(lens))
    for tb in tc["layers"]:
        tb["len"].copy_(torch.from_numpy(lens))
        if paged:
            tb["block_table"].copy_(torch.from_numpy(tables))
    return jc, tc


@pytest.mark.parametrize("arch,level,paged", [
    ("granite-3-8b", "bitplane", False), ("granite-3-8b", "bitplane", True),
    ("yi-6b", "digit", False), ("yi-6b", "digit", True),
])
def test_static_buffer_step_equals_reference(arch, level, paged, monkeypatch):
    """The graph's callable, uncaptured: logits and greedy tokens of every
    step bit-equal to the reference's compiled decode forward, on one cache
    updated in place (at bitplane level across the 8 -> 4 switch)."""
    jp, tp = _params(arch)
    cfg, jcfg = tget(arch), jget(arch)
    tpol, jpol = TPolicy.uniform(8, 8, level=level), JPolicy.uniform(8, 8, level=level)
    tq = tquantize_params(tp, tpol, cfg=cfg, plane_cache=True)
    jq = _to_jax_tree(tq)
    jc, tc = _caches(cfg, jcfg, paged)
    seen = []
    real_mask = sampling.mask_vocab
    monkeypatch.setattr(sampling, "mask_vocab",
                        lambda lg, v: seen.append(real_mask(lg, v)) or seen[-1])
    rng = np.random.default_rng(3)
    first = rng.integers(0, cfg.vocab_size, (N_SLOTS, 1)).astype(np.int32)
    state = {"cache": tc, "tokens": torch.from_numpy(first.copy()),
             "temps": torch.zeros((N_SLOTS,), dtype=torch.float32)}
    cache_ids = [id(t) for t in [tc["step"]] + [v for b in tc["layers"] for v in b.values()]]
    jtok = jnp.asarray(first)
    bodies, jfwd = {}, {}
    for t in range(STEPS):
        prec = (4, 4) if level == "bitplane" and t >= SWITCH_AT else None
        if prec not in bodies:
            bodies[prec] = serve._decode_body(
                make_cb_decode_step(cfg, tpol, precision=prec), tq, check=False)
            pol = jpol if prec is None else jpol.with_runtime_bits(*prec)
            jfwd[prec] = jax.jit(lambda p, x, c, pol=pol: jforward(
                jcfg, p, {"tokens": x}, policy=pol, cache=c))
        out = bodies[prec](state, None)
        logits, _, jc = jfwd[prec](jq, jtok, jc)
        jl = jsampling.mask_vocab(logits[:, -1, :], jcfg.vocab_size)
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
        np.testing.assert_array_equal(np.asarray(jl).astype(np.float32), t2n(seen[-1]),
                                      err_msg=f"step {t}")
        np.testing.assert_array_equal(np.asarray(jtok), t2n(state["tokens"]))
        np.testing.assert_array_equal(np.asarray(jtok)[:, 0], t2n(out))
    # every step left its results in the buffers it read
    assert [id(t) for t in [tc["step"]] + [v for b in tc["layers"] for v in b.values()]] \
        == cache_ids
    np.testing.assert_array_equal(t2n(tc["step"]), np.asarray(START_LENS) + STEPS)
    np.testing.assert_array_equal(t2n(tc["step"]), np.asarray(jc["step"]))


def _where_append(cache, k, v):
    """The functional masked-select append the in-place one replaced."""
    pos = cache["len"]
    s_max = cache["k_q"].shape[1]
    write = torch.arange(s_max)[None, :] == pos[:, None]
    out = {}
    for key, val in (("k", k), ("v", v)):
        q, sc = quantize_kv(val)
        out[f"{key}_q"] = torch.where(write[:, :, None, None], q, cache[f"{key}_q"])
        out[f"{key}_scale"] = torch.where(write[:, :, None], sc, cache[f"{key}_scale"])
    return out


def test_in_place_dense_append_equals_where_append():
    """Slots at lengths 0, 5, 7 (the last row) and 8 (at the extent: writes
    nothing) of an 8-position int8 cache."""
    cfg = tget("granite-3-8b")
    g = torch.Generator().manual_seed(5)
    b, s_max, hkv, d = 4, 8, cfg.n_kv_heads, cfg.head_dim
    blk = {"len": torch.tensor([0, 5, 7, 8], dtype=torch.int32),
           "k_q": torch.randint(-127, 128, (b, s_max, hkv, d), generator=g, dtype=torch.int8),
           "v_q": torch.randint(-127, 128, (b, s_max, hkv, d), generator=g, dtype=torch.int8),
           "k_scale": torch.rand((b, s_max, hkv), generator=g),
           "v_scale": torch.rand((b, s_max, hkv), generator=g)}
    params = {n: {"w": torch.randn((cfg.d_model, cols), generator=g).to(torch.bfloat16)}
              for n, cols in (("q_proj", cfg.n_heads * d), ("k_proj", hkv * d),
                              ("v_proj", hkv * d), ("o_proj", cfg.d_model))}
    params["o_proj"]["w"] = torch.randn((cfg.n_heads * d, cfg.d_model), generator=g).to(
        torch.bfloat16)
    x = torch.randn((b, 1, cfg.d_model), generator=g).to(torch.bfloat16)
    pos = blk["len"][:, None]
    # the new K/V rows, as the layer computes them
    from repro_torch.layers.rotary import apply_rope

    k = apply_rope((x @ params["k_proj"]["w"]).reshape(b, 1, hkv, d), pos, cfg.rope_theta)
    v = (x @ params["v_proj"]["w"]).reshape(b, 1, hkv, d)
    want = _where_append(blk, k, v)
    before = {key: t.clone() for key, t in blk.items()}
    attention.attention_apply(
        params, x, pos, n_heads=cfg.n_heads, n_kv_heads=hkv, head_dim=d,
        rope_theta=cfg.rope_theta, policy=TPolicy.off(), backend="torch", cache=blk)
    for key, val in want.items():
        assert torch.equal(blk[key], val), key
    assert torch.equal(blk["k_q"][3], before["k_q"][3])  # the slot at the extent
    assert blk["len"].tolist() == [1, 6, 8, 9]


# ---------------------------------------------------------------------------
# No read-back, no host data, in one step of every route
# ---------------------------------------------------------------------------


ROUTES = {  # cell: (policy kwargs, engine kwargs, scan_layers)
    "fused": (dict(level="bitplane"), {}, True),
    "digit": (dict(level="digit"), {}, True),
    "packed": (dict(level="bitplane", fuse_epilogue=False), {}, True),
    "detect_unrolled": (dict(level="bitplane", integrity="detect"), {}, False),
    "detect_scanned": (dict(level="bitplane", integrity="detect"), {}, True),
    "paged": (dict(level="bitplane"), dict(page_size=PAGE), True),
}


@pytest.mark.parametrize("temps", [(0.0, 0.0), (0.0, 0.8)], ids=["greedy", "sampled"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_decode_step_reads_nothing_back(route, temps, monkeypatch):
    import dataclasses

    pol_kw, eng_kw, scan = ROUTES[route]
    cfg = dataclasses.replace(tget("granite-3-8b"), scan_layers=scan)
    stub_kernels(monkeypatch)
    eng = serve.ContinuousBatchingEngine(
        cfg, _params("granite-3-8b")[1], TPolicy.uniform(8, 8, **pol_kw), n_slots=N_SLOTS,
        max_len=MAX_LEN, device="cpu", **eng_kw)
    eng.set_precision(4 if route not in ("digit",) else None)
    eng._temps.copy_(torch.tensor(temps))
    eng._decode(0)  # warm-up: builds the constants every later step reuses
    want = {"fused": "fused_cached", "digit": "cached_planes", "packed": "cached_packed",
            "paged": "fused_cached"}.get(route, "cached_packed")
    calls0 = plan_mod.DEFAULT_REGISTRY.calls[want]
    with Watch() as watch:
        out, _ = eng._decode(1)
    assert watch.bad == []
    assert plan_mod.DEFAULT_REGISTRY.calls[want] - calls0 == 7 * cfg.n_layers + 1
    assert out.shape[0] >= N_SLOTS


# ---------------------------------------------------------------------------
# The fold kernel's model
# ---------------------------------------------------------------------------


def test_fold_model_equals_both_packages_fingerprints(rng):
    """Ragged leaves of every dtype (and one of two chunks), the KV cache's
    slots: the kernel's chunked model equals the port's and the reference's
    plain folds, and a flipped bit moves the total it lands in."""
    arrays = {
        "i8": rng.integers(-128, 128, (3, 7)).astype(np.int8),
        "i32": rng.integers(-(2**31), 2**31, (5,)).astype(np.int32),
        "f32": rng.standard_normal((4, 3)).astype(np.float32),
        "big": rng.integers(0, 256, (fold.CHUNK_BYTES + 37,)).astype(np.uint8),
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((6,)), jnp.bfloat16)),
    }
    tt = {k: torch.from_numpy((v.view(np.int16) if v.dtype == jnp.bfloat16 else v).copy())
          for k, v in arrays.items()}
    tt["bf16"] = tt["bf16"].view(torch.bfloat16)
    want = int(tinteg.tree_checksum(tt))
    assert want == int(jinteg.tree_checksum({k: jnp.asarray(v) for k, v in arrays.items()}))
    assert int(fold.chunked_fold(list(tinteg._leaves(tt)), 1)[0]) == want
    tt["big"][fold.CHUNK_BYTES + 5] ^= 64  # in the leaf's second chunk
    moved = (int(fold.chunked_fold(list(tinteg._leaves(tt)), 1)[0]) - want) % 2**32
    assert moved in (64, 2**32 - 64)

    jcfg, cfg = jget("granite-3-8b"), tget("granite-3-8b")
    jc = jinit_cache(jcfg, 3, 8, kv_quant=True)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return rng.standard_normal(a.shape).astype(np.float32)
        info = np.iinfo(a.dtype)
        return rng.integers(info.min, info.max, a.shape, endpoint=True).astype(a.dtype)

    cnp = jax.tree_util.tree_map(fill, jc)
    stack = cnp["periods"]["b0_dense"]
    tc = {"step": torch.from_numpy(cnp["step"].copy()),
          "layers": [{k: torch.from_numpy(v[i].copy()) for k, v in stack.items()}
                     for i in range(cfg.n_layers)]}
    leaves = [tc["step"]] + [v for blk in tc["layers"] for v in blk.values()]
    got = fold.chunked_fold(leaves, 3)
    assert torch.equal(got, tslot_checksums(tc))
    np.testing.assert_array_equal(
        np.asarray(jslot_checksums(jax.tree_util.tree_map(jnp.asarray, cnp))).astype(np.int64),
        t2n(got))
    tc["layers"][1]["v_scale"][2, 4, 1] *= -1  # the sign bit
    moved = (fold.chunked_fold(leaves, 3) != got).tolist()
    assert moved == [False, False, True]
    assert torch.equal(fold.slot_folds(tc), tslot_checksums(tc))  # host: the plain version
    assert int(fold.tree_fold(tt)) == int(tinteg.tree_checksum(tt))


# ---------------------------------------------------------------------------
# The counter tally per replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_replay_tally_gives_the_eager_counts(scan):
    """Detect mode through 2 slots with an 8 -> 4 switch: the stub-runner
    engine captures one step per precision and its tallied route calls,
    ABFT checks and tokens equal the eager engine's."""
    import dataclasses

    cfg = dataclasses.replace(tget("granite-3-8b"), scan_layers=scan)
    pol = TPolicy.uniform(8, 8, level="bitplane", integrity="detect")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (s,)) for s in (5, 9)]

    def serve_with(runner):
        eng = serve.ContinuousBatchingEngine(cfg, _params("granite-3-8b")[1], pol,
                                             n_slots=N_SLOTS, max_len=24, device="cpu")
        eng._runner = runner
        reqs = [TRequest(rid=i, tokens=p, max_new_tokens=4, arrival_step=2 * i)
                for i, p in enumerate(prompts)]
        return eng, eng.run(reqs, precision_schedule={2: 4})

    _, (r_eager, s_eager) = serve_with(None)
    eng, (r_graph, s_graph) = serve_with(StubRunner)
    assert set(eng.capture_s) == {None, (4, 4)}
    assert set(s_graph["capture_s"]) == {"None", "(4, 4)"}
    replays = sum(g.runner.replays for g in eng._compiled_graphs.values())
    assert replays == s_graph["decode_steps"] == s_eager["decode_steps"]
    assert s_graph["route_calls"] == s_eager["route_calls"]
    assert s_graph["integrity"] == s_eager["integrity"]
    assert s_graph["integrity"]["abft_checks"] > 0
    for rid in r_eager:
        np.testing.assert_array_equal(r_eager[rid], r_graph[rid])
    _, (r_again, s_again) = serve_with(StubRunner)  # a second engine: its own graphs
    assert s_again["route_calls"] == s_eager["route_calls"]


def test_backend_torch_on_cuda_needs_eager_steps(monkeypatch):
    """The plain versions read values back: a CUDA engine on them must be
    asked to run its steps eagerly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="compile_steps=False"):
        serve.ContinuousBatchingEngine(tget("granite-3-8b"), {}, TPolicy.uniform(8, 8),
                                       device="cuda", backend="torch")
