"""Port parity of scrub-mode serving and paged integrity, on the CPU.

On reduced granite-3-8b (layers unrolled, so the injector's walk meets the
same leaves in both packages), the port's scrub engine and the
reference's, given the same quantized tree, the same requests and the
same seeded fault spec, must:

* emit the same greedy tokens, equal to the clean run's;
* report every ``stats()["integrity"]`` count the same, exactly;
* record the same ``FaultEvent``s (leaf, byte, bit) with the same
  ``detected`` flags;

dense (the two-site spec ``planes@2,kv@3;seed=5`` and the reference's
seven-site smoke spec, audits every iteration; and ``planes@2,sign@9``
with the audits off, where the decode step's ABFT alarm is recovered by a
retry) and paged (a seeded KV spec plus one flip placed in a page of the
shared prefix while several slots hold it). Every quantized leaf keeps its
``data_ptr`` through the scrubs. The paged detect engine gives the dense
detect engine's tokens with no false alarm. A corrupted retained source and
an alarm that outlasts ``max_retries`` raise ``IntegrityError``. A retried
decode step through the stub graph runner gives the eager step's tokens
and counts.

The reference's engine is handed the port's quantized tree (held equal to
its own by test_torch_serving.py and, for the checksummed caches, by
test_torch_faults.py) in place of its eager quantization, which would cost
~13 s per engine.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch import serve as jserve
from repro.models.transformer import init_params as jinit
from repro.runtime.faults import FaultInjector as JInjector
from repro.runtime.scheduler import Request as JRequest
from repro_torch.configs import get_reduced as tget
from repro_torch.core import integrity
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.launch import graphs
from repro_torch.launch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.models.transformer import params_from_numpy
from repro_torch.runtime.faults import FaultInjector, flip_bit
from repro_torch.runtime.scheduler import Request as TRequest

from _torch_parity import StubRunner, quantized_to_jax, to_numpy_tree

ARCH = "granite-3-8b"
SEVEN = "planes@2,sign@3,occupancy@4,checksum@5,scale@6,kv@7,kv_scale@8;seed=11"
DENSE = dict(n_slots=2, max_len=20)
# paged: a shared 8-token prefix in pages of 4, chunks of 8, three slots
PAGED = dict(n_slots=3, max_len=24, page_size=4, prefill_chunk=8, share_prefixes=True)
PREFIX = 8

_S: dict = {}


def _setup():
    """The carried parameters and, per policy and layout, one engine of each
    package, built once."""
    if not _S:
        jc = dataclasses.replace(jget(ARCH), scan_layers=False)
        tc = dataclasses.replace(tget(ARCH), scan_layers=False)
        jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(0))
        _S.update(jc=jc, tc=tc, jp=jp, tp=params_from_numpy(tc, to_numpy_tree(jp), device="cpu"))
    return _S


@contextlib.contextmanager
def _port_quantization(tree):
    """The reference engine quantizes (at load and in every scrub) into a
    fresh copy of ``tree``, the port's quantized tree in its layout."""
    orig = jserve.quantize_params
    jserve.quantize_params = lambda *a, **k: quantized_to_jax(tree)
    try:
        yield
    finally:
        jserve.quantize_params = orig


def _engines(mode: str, layout: str):
    key = (mode, layout)
    if key not in _S:
        st = _setup()
        kw = PAGED if layout == "paged" else DENSE
        te = TEngine(st["tc"], st["tp"], TPolicy.uniform(8, 8, level="bitplane", integrity=mode),
                     device="cpu", **kw)
        pristine = te._requantize(st["tp"])
        with _port_quantization(pristine):
            je = jserve.ContinuousBatchingEngine(
                st["jc"], st["jp"], JPolicy.uniform(8, 8, level="bitplane", integrity=mode), **kw)
        _S[key] = (je, te, pristine)
    return _S[key]


def _dense_requests(cls):
    rng = np.random.default_rng(0)
    return [cls(rid=i, tokens=rng.integers(0, 512, (s,)), max_new_tokens=12, arrival_step=0)
            for i, s in enumerate((4, 8))]


def _paged_requests(cls):
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 512, (PREFIX,))
    return [cls(rid=i, tokens=np.concatenate([prefix, rng.integers(0, 512, (s,))]),
                max_new_tokens=8, arrival_step=i, shared_prefix_len=PREFIX)
            for i, s in enumerate((4, 4, 4))]


def _events(inj):
    return [(e.site, e.step, e.leaf, e.byte, e.bit, e.category, e.detected) for e in inj.events]


def _leaf_ptrs(tree):
    return [t.data_ptr() for t in integrity._leaves(tree)]


def _serve(engine, reqs, injector=None, pristine=None):
    if pristine is None:  # the port
        return engine.run(reqs, injector=injector)
    with _port_quantization(pristine):
        return engine.run(reqs, injector=injector)


def _same(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), what
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid], err_msg=f"{what}: request {rid}")


def _parity(layout, audit_interval, spec_j, spec_t, requests):
    """Clean run, then the faulted run on both packages: tokens, counts and
    events equal; the faulted tokens equal the clean ones; every quantized
    leaf keeps its address. Returns the port's stats and injector."""
    je, te, pristine = _engines("scrub", layout)
    je.audit_interval = te.audit_interval = audit_interval
    clean, _ = _serve(te, requests(TRequest))
    ptrs = _leaf_ptrs(te.q_params)
    rj, sj = _serve(je, requests(JRequest), spec_j, pristine)
    rt, st = _serve(te, requests(TRequest), spec_t)
    _same(rj, rt, "the reference's scrub engine")
    _same(clean, rt, "the clean run")
    assert st["integrity"] == sj["integrity"]
    assert st["failed"] == sj["failed"] == {}
    assert _events(spec_t) == _events(spec_j)
    assert _leaf_ptrs(te.q_params) == ptrs
    return st, spec_t


@pytest.mark.parametrize("spec", ["planes@2,kv@3;seed=5", SEVEN], ids=["two_sites", "seven_sites"])
def test_dense_scrub_equals_reference(spec):
    st, inj = _parity("dense", 1, JInjector(spec), FaultInjector(spec), _dense_requests)
    ig = st["integrity"]
    assert not inj.undetected and ig["scrubs"] >= 1 and ig["requeued"] >= 1
    assert ig["step_retries"] == 0  # the audit at the top of the iteration finds the flips


def test_scrub_retry_equals_reference():
    """Audits off: the flip at iteration 2 (a decode step) is found by the
    step's ABFT check, the step is put back, scrubbed and replayed. (The
    sign flip at 9 is not seen: on the host the route reads raw planes.)"""
    spec = "planes@2,sign@9;seed=11"
    st, inj = _parity("dense", 0, JInjector(spec), FaultInjector(spec), _dense_requests)
    ig = st["integrity"]
    assert ig["step_retries"] >= 1 and ig["scrubs"] >= 1 and ig["abft_alarms"] >= 1
    assert [e.detected for e in inj.events] == [True, False]


class _PlacedFlip:
    """A seeded injector plus one bit flipped at ``step`` in KV page
    ``page`` of layer 0's ``k_q`` pool, in both packages' caches."""

    def __init__(self, base, step: int, page: int, jax_side: bool):
        self.base, self.step, self.page, self.jax_side = base, step, page, jax_side
        self.events = base.events

    def apply(self, step, params, cache=None):
        params, cache = self.base.apply(step, params, cache)
        if step == self.step:
            blk = cache["layers"][0]
            if self.jax_side:
                blk["k_q"] = blk["k_q"].at[self.page, 1, 0, 3].set(blk["k_q"][self.page, 1, 0, 3] ^ 4)
            else:
                flip_bit(blk["k_q"][self.page, 1, 0, 3], 0, 2)
        return params, cache

    def mark_detected(self, category, step):
        return self.base.mark_detected(category, step)

    @property
    def undetected(self):
        return self.base.undetected


def test_paged_scrub_equals_reference():
    """Seeded kv / kv_scale flips and one flip in page 1, the first page of
    the shared prefix, once the second and third requests map it: the
    holders are requeued, every flip outside the null page is detected,
    tokens equal the clean run's and the reference's."""
    spec = "kv@3,kv_scale@5;seed=2"
    st, inj = _parity("paged", 1, _PlacedFlip(JInjector(spec), 4, 1, True),
                      _PlacedFlip(FaultInjector(spec), 4, 1, False), _paged_requests)
    ig = st["integrity"]
    assert ig["page_faults"] >= 1 and ig["requeued"] >= 2 and ig["kv_alarms"] >= 1
    pages = st["paging"]
    assert pages["shared_prefix_hits"] >= 1
    # a seeded flip on the null page is never attributed; every other is found
    assert all(e.detected for e in inj.events if e.byte >= _page_bytes(e.leaf))


def _page_bytes(leaf_path: str) -> int:
    """Bytes of one page of the pool named by an event's path (page 0 is
    the null page): positions x KV heads (x head_dim for the values)."""
    cfg = _setup()["tc"]
    per = PAGED["page_size"] * cfg.n_kv_heads
    return per * cfg.head_dim if leaf_path.endswith("_q") else per * 4


def test_paged_detect_gives_dense_detect_tokens():
    """The counterpart of the reference's paged detect parity test: per-page
    checksums raise no false alarm and leave the tokens of the dense detect
    engine; a flipped KV bit in a live page then raises a KV alarm."""
    st = _setup()
    policy = TPolicy.uniform(8, 8, level="bitplane", integrity="detect")
    dense = TEngine(st["tc"], st["tp"], policy, n_slots=3, max_len=24, device="cpu")
    rd, sd = dense.run(_paged_requests(TRequest))
    paged = TEngine(st["tc"], st["tp"], policy, device="cpu", **PAGED)
    rp, sp = paged.run(_paged_requests(TRequest))
    _same(rd, rp, "the dense detect engine")
    assert sp["integrity"]["kv_alarms"] == 0 and sp["integrity"]["page_faults"] == 0
    assert sp["integrity"]["kv_checks"] > 0 and sp["integrity"]["abft_checks"] > 0
    inj = _PlacedFlip(FaultInjector("scale@999"), 4, 1, False)
    _, sf = paged.run(_paged_requests(TRequest), injector=inj)
    assert sf["integrity"]["kv_alarms"] >= 1 and sf["integrity"]["page_faults"] == 0


def test_unrecoverable_faults_raise():
    """A corrupted retained source fails the rebuild's fingerprint check;
    an ABFT alarm that a scrub cannot clear outlasts max_retries."""
    st = _setup()
    policy = TPolicy.uniform(8, 8, level="bitplane", integrity="scrub")
    src = dict(st["tp"], lm_head=graphs.clone_tree(st["tp"]["lm_head"]))
    eng = TEngine(st["tc"], src, policy, device="cpu", **DENSE)
    flip_bit(next(integrity._leaves(src["lm_head"])), 100, 6)
    with pytest.raises(integrity.IntegrityError, match="retained source"):
        eng.run(_dense_requests(TRequest), injector=FaultInjector("scale@1;seed=1"))
    eng = TEngine(st["tc"], st["tp"], policy, device="cpu", audit_interval=0, **DENSE)
    eng._scrub = lambda: None  # a scrub that repairs nothing
    with pytest.raises(integrity.IntegrityError, match="persisted through 2"):
        eng.run(_dense_requests(TRequest), injector=FaultInjector("planes@2;seed=11"))
    with pytest.raises(integrity.IntegrityError, match="not retained"):
        TEngine(st["tc"], st["tp"], TPolicy.uniform(8, 8, level="bitplane", integrity="detect"),
                device="cpu", **DENSE)._scrub()


def test_retried_decode_under_stub_runner_equals_eager():
    """The decode retry through a runner that replays like a graph: the
    replayed step restores its state from the backup the captured body
    wrote, and gives the eager step's tokens, counts and replays."""
    _, te, _ = _engines("scrub", "dense")
    te.audit_interval = 0
    spec = "planes@2;seed=11"
    r_eager, s_eager = te.run(_dense_requests(TRequest), injector=FaultInjector(spec))
    st = _setup()
    eng = TEngine(st["tc"], st["tp"], TPolicy.uniform(8, 8, level="bitplane", integrity="scrub"),
                  device="cpu", audit_interval=0, **DENSE)
    eng._runner = StubRunner
    ptrs = _leaf_ptrs(eng.q_params)
    r_graph, s_graph = eng.run(_dense_requests(TRequest), injector=FaultInjector(spec))
    _same(r_eager, r_graph, "the eager step")
    assert s_graph["integrity"] == s_eager["integrity"]
    assert s_graph["integrity"]["step_retries"] >= 1
    replays = sum(g.runner.replays for g in eng._compiled_graphs.values())
    assert replays == s_graph["decode_steps"] + s_graph["integrity"]["step_retries"]
    assert list(eng.capture_s) == [None] and _leaf_ptrs(eng.q_params) == ptrs
