"""Port parity of the paged serving engine, on the CPU (the plain versions).

Mirrors the reference's tests/test_paged_serving.py: a staggered
mixed-length workload whose prompts open with the same 12-token prefix,
served with pages of 8 positions, chunked prefill (8 tokens) and
copy-on-write prefix sharing, must give the reference paged engine's
greedy tokens and the port's own dense engine's, bit for bit, with the
reference's paging counts. Across a mid-run 8 -> 4 bit switch the port's
paged engine still gives the reference's tokens; against the dense engine
it is held with monolithic prefill, as the reference holds it (a chunked
prefill admits later, so the switch lands at another point of a
request's life). Sharing must lower the peak of resident pages. The
constructor and the CLI refuse what the reference refuses, and accept
paged KV together with detect-mode integrity (per-page checksums).
"""

import jax
import numpy as np
import pytest

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch.serve import ContinuousBatchingEngine as JEngine
from repro.models.transformer import init_params as jinit
from repro.runtime.scheduler import Request as JRequest
from repro_torch.configs import get_reduced as tget
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.launch import serve
from repro_torch.launch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.scheduler import Request as TRequest

from _torch_parity import to_numpy_tree

ARCH = "granite-3-8b"
GEN = 5
PREFIX_LEN = 12
LENS = [20, 33, 20, 27, 45]
PAGED = dict(page_size=8, prefill_chunk=8, share_prefixes=True)
SCHEDULES = {"static": None, "switch_8_to_4": {6: 4}}

_STATE: dict = {}


def _setup():
    """(JAX params, port params, JAX paged engine) once per module: the
    reference quantizes its weights eagerly, op by op, in its constructor."""
    if not _STATE:
        jp = jax.jit(lambda k: jinit(jget(ARCH), k))(jax.random.PRNGKey(0))
        _STATE["params"] = (jp, params_from_numpy(tget(ARCH), to_numpy_tree(jp), device="cpu"))
        _STATE["jpaged"] = JEngine(jget(ARCH), jp, JPolicy.uniform(8, 8, level="bitplane"),
                                   n_slots=3, max_len=64, **PAGED)
    return _STATE


def _requests(cls, vocab, share=True):
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, (PREFIX_LEN,))
    body = np.random.default_rng(1)
    return [
        cls(rid=i, tokens=np.concatenate([prefix, body.integers(0, vocab, (s - PREFIX_LEN,))]),
            max_new_tokens=GEN, arrival_step=i * 2,
            shared_prefix_len=PREFIX_LEN if share else 0)
        for i, s in enumerate(LENS)
    ]


def _tengine(**kw):
    return TEngine(tget(ARCH), _setup()["params"][1], TPolicy.uniform(8, 8, level="bitplane"),
                   n_slots=3, max_len=64, device="cpu", **kw)


def _same(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b) == list(range(len(LENS)))
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid], err_msg=f"{what}: request {rid}")


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_paged_engine_gives_reference_and_dense_tokens(schedule):
    st = _setup()
    sched = SCHEDULES[schedule]
    jeng = st["jpaged"]
    jeng.set_precision(None)
    rj, sj = jeng.run(_requests(JRequest, jget(ARCH).vocab_size), precision_schedule=sched)
    treqs = lambda: _requests(TRequest, tget(ARCH).vocab_size)  # noqa: E731
    rt, stt = _tengine(**PAGED).run(treqs(), precision_schedule=sched)
    rd, _ = _tengine().run(treqs(), precision_schedule=sched)
    _same(rj, rt, "reference paged engine")
    if sched is None:
        _same(rd, rt, "port dense engine")
    else:
        rm, _ = _tengine(page_size=8, share_prefixes=True).run(treqs(), precision_schedule=sched)
        _same(rd, rm, "port dense engine (monolithic prefill)")
    assert stt["precision_switches"] == sj["precision_switches"]
    assert stt["prefill_chunks"] == sj["prefill_chunks"] > len(LENS)
    assert stt["decode_steps"] == sj["decode_steps"]
    pg = stt["paging"]
    for key, val in pg.items():
        assert sj["paging"][key] == val, key
    assert pg["shared_prefix_hits"] >= 1
    assert pg["kv_bytes_resident_peak"] == pg["peak_used_pages"] * pg["page_nbytes"]
    assert set(stt["route_calls"]) == {"cached_scan"}


def test_prefix_sharing_lowers_resident_pages():
    shared = _tengine(page_size=8, share_prefixes=True)
    r_shared, s_shared = shared.run(_requests(TRequest, tget(ARCH).vocab_size))
    unshared = _tengine(page_size=8)
    r_unshared, s_unshared = unshared.run(_requests(TRequest, tget(ARCH).vocab_size, share=False))
    _same(r_unshared, r_shared, "unshared paged engine")
    assert s_shared["paging"]["peak_used_pages"] < s_unshared["paging"]["peak_used_pages"]
    assert s_shared["paging"]["shared_prefix_hits"] >= 1
    assert s_unshared["paging"]["shared_prefix_hits"] == 0


def test_constructor_and_cli_refuse_what_the_reference_refuses():
    with pytest.raises(ValueError, match="kv_quant"):
        _tengine(page_size=8, kv_quant=False)
    with pytest.raises(ValueError, match="divisible"):
        TEngine(tget(ARCH), _setup()["params"][1], TPolicy.uniform(8, 8), n_slots=2,
                max_len=30, page_size=8, device="cpu")
    with pytest.raises(ValueError, match="share_prefixes"):
        _tengine(share_prefixes=True)
    with pytest.raises(ValueError, match="kv_pages needs"):
        _tengine(kv_pages=9)
    with pytest.raises(ValueError, match="null page"):
        _tengine(page_size=8, kv_pages=8)
    with pytest.raises(ValueError, match="prefill_chunk"):
        _tengine(prefill_chunk=-1)
    detect = TPolicy.uniform(8, 8, level="bitplane", integrity="detect")
    paged_detect = TEngine(tget(ARCH), _setup()["params"][1], detect, n_slots=2, max_len=32,
                           page_size=8, device="cpu")
    assert paged_detect.paged and paged_detect.integrity == "detect"
    serve.main(["--reduced", "--level", "bitplane", "--device", "cpu", "--n-slots", "2",
                "--prompt-lens", "9,12", "--gen", "2", "--kv-page-size", "8",
                "--integrity", "detect"])
    base = ["--reduced", "--level", "bitplane", "--device", "cpu"]
    for flags, words in (
        (["--kv-page-size", "-1"], "--kv-page-size must be >= 0"),
        (["--prefill-chunk", "-2"], "--prefill-chunk must be >= 0"),
        (["--kv-pages", "9"], "--kv-pages needs --kv-page-size"),
        (["--kv-page-size", "8", "--kv-pages", "1"], "--kv-pages must be >= 2"),
        (["--share-prefixes"], "--share-prefixes needs --kv-page-size"),
        (["--shared-prefix-len", "-1"], "--shared-prefix-len must be >= 0"),
        (["--shared-prefix-len", "9", "--prompt-lens", "9,12"], "shorter than every prompt"),
    ):
        with pytest.raises(SystemExit, match=words):
            serve.main(base + flags)


def test_cli_serves_paged_on_the_host(capsys):
    serve.main(["--reduced", "--bits", "8", "--level", "bitplane", "--device", "cpu",
                "--n-slots", "2", "--prompt-lens", "13,20", "--gen", "3",
                "--kv-page-size", "8", "--prefill-chunk", "8", "--share-prefixes",
                "--shared-prefix-len", "12"])
    out = capsys.readouterr().out
    assert "2 requests" in out and "paging:" in out and "1 shared-prefix hits" in out


def test_lane_free_longer_than_its_table_spans():
    """One request at a time through 2 slots: slot 1 stays free for more
    decode steps than its 2-page table spans (its length keeps counting,
    as in the reference), and its writes stay on the null page; tokens
    equal the dense engine's."""
    def reqs():
        return [TRequest(rid=i, tokens=np.random.default_rng(i).integers(0, 512, (4,)),
                         max_new_tokens=8, arrival_step=9 * i) for i in range(5)]

    kw = dict(n_slots=2, max_len=16, device="cpu")
    policy = TPolicy.uniform(8, 8, level="bitplane")
    params = _setup()["params"][1]
    rp, sp = TEngine(tget(ARCH), params, policy, page_size=8, **kw).run(reqs())
    rd, _ = TEngine(tget(ARCH), params, policy, **kw).run(reqs())
    assert sp["decode_steps"] > 16
    assert sorted(rp) == sorted(rd) == list(range(5))
    for rid in rd:
        np.testing.assert_array_equal(rp[rid], rd[rid])
