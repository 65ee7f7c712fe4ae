"""Port parity of the analysis layer: the paper's systolic cycle and MAC
model (``core/systolic.py``), ``booth_nonzero_digit_count``, the shape
cells and ``input_specs``, the roofline terms and the per-call bound
(``launch/roofline.py``), the train step's ``grad_accum_dtype``, the dry
run of the production-mesh cells (``launch/dryrun.py``) and the
collectives it records (``launch/cost.py``) against a real gloo step.

Tolerances, stated once:

* the systolic model, the simulators (results and cycles), the digit
  counts, the shape cells, ``input_specs``, ``model_flops``, the roofline
  terms and the wire bytes: equal (floats to 1e-12 relative);
* the per-call bound: PERF.md §6's figures to their 4 significant digits
  (0.0314 ms at the rows 1-3 decode gate shape, 0.1390 ms at A4);
* ``grad_accum_dtype=bfloat16`` at 2 microbatches (8-bit QAT, the policy
  of ``tests/test_torch_train.py``'s one-step test): that test's tolerance
  (the loss within 1e-6 relative, the gradient norm within 1e-4, at least
  97% of each updated bf16 leaf equal, the rest within an update of the
  other sign);
* the dry-recorded collectives and a real gloo step's: equal counts and
  operand bytes of each kind (the dense step's collectives do not depend
  on data).
"""

import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import ARCH_NAMES as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import all_cells as jall_cells
from repro.configs import cell_applicable as jcell_applicable
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget
from repro.core import bitplanes as jbp
from repro.core import systolic as jsa
from repro.core.autotune import HardwareModel as JHardwareModel
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch import hlo_cost as jhlo_cost
from repro.launch import roofline as jroofline
from repro.launch.inputs import input_specs as jinput_specs
from repro.launch.steps import init_opt_state as jinit_opt, make_train_step as jmake_step
from repro.models.transformer import init_params as jinit
from repro.optim import OptimConfig as JOptimConfig
from repro_torch.configs import ARCH_NAMES, SHAPES, all_cells, cell_applicable, get_config
from repro_torch.configs import get_reduced as tget
from repro_torch.core import bitplanes as tbp
from repro_torch.core import systolic as tsa
from repro_torch.core import tree as tr
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import make_dry_mesh, spawn_ranks
from repro_torch.launch.steps import init_opt_state, make_train_step
from repro_torch.launch.train import init_blocks
from repro_torch.optim import OptimConfig
from repro_torch.sharding import rules as sh
from repro_torch.sharding.collectives import recording

import _torch_mesh_ranks as ranks
from _torch_parity import j2t, t2n

#: the collective kinds, under the reference's (XLA's) names
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# -- the systolic model -------------------------------------------------------


def test_analytic_model_equals_reference():
    for (t, j), bits, n in itertools.product(
            zip(tsa.PAPER_TOPOLOGIES, jsa.PAPER_TOPOLOGIES), range(1, 17), (1, 7, 100, 1000)):
        assert (t.width, t.height, t.max_bits, t.n_macs) == (j.width, j.height, j.max_bits,
                                                             j.n_macs)
        assert tsa.bismo_dot_cycles(bits, 17 - bits, n) == jsa.bismo_dot_cycles(bits, 17 - bits, n)
        assert tsa.bitsmm_dot_cycles(bits, n) == jsa.bitsmm_dot_cycles(bits, n)
        assert tsa.matmul_total_cycles(t, n, bits) == jsa.matmul_total_cycles(j, n, bits)
        assert tsa.op_per_cycle(t, n, t.width, t.height, bits) == \
            jsa.op_per_cycle(j, n, j.width, j.height, bits)
        assert tsa.peak_op_per_cycle(t, bits) == jsa.peak_op_per_cycle(j, bits)
        assert tsa.gops(t, bits, 1e9) == jsa.gops(j, bits, 1e9)
    for t, j in zip(tsa.PAPER_TOPOLOGIES, jsa.PAPER_TOPOLOGIES):
        assert tsa.readout_cycles(t) == jsa.readout_cycles(j)
        assert tsa.pipeline_register_count(t) == jsa.pipeline_register_count(j)
        assert tsa.mux_count(t) == jsa.mux_count(j)


PAPER_FPGA_GOPS = {(16, 4): 1.2, (32, 8): 4.8, (64, 16): 19.2}  # Table II @300MHz
PAPER_ASAP7 = {  # Table III: (max_freq_MHz, peak_GOPS, target_MHz, target_GOPS)
    (16, 4): (1183, 4.73, 1000, 4),
    (32, 8): (1124, 17.98, 1000, 16),
    (64, 16): (1144, 73.22, 1000, 64),
}


def test_paper_tables_gops():
    for (w, h), gops in PAPER_FPGA_GOPS.items():
        assert abs(tsa.gops(tsa.SAConfig(w, h), 16, 300e6) - gops) < 1e-9
    for (w, h), (fmax, peak, ftgt, tgt) in PAPER_ASAP7.items():
        cfg = tsa.SAConfig(w, h)
        assert abs(tsa.gops(cfg, 16, fmax * 1e6) - peak) < 0.01
        assert abs(tsa.gops(cfg, 16, ftgt * 1e6) - tgt) < 1e-9


@pytest.mark.parametrize("bits", [2, 5, 8, 12, 16])
def test_mac_simulators_equal_reference(bits):
    """One reference call per variant (each a ``lax.scan``): 40 random
    values; results and cycles equal, and equal to the exact product
    modulo 2^32 (the int32 accumulator)."""
    rng = np.random.default_rng(bits)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    mc = rng.integers(lo, hi + 1, 40).astype(np.int32)
    ml = rng.integers(lo, hi + 1, 40).astype(np.int32)
    exact = int(np.sum(mc.astype(np.int64) * ml.astype(np.int64)))
    wrapped = (exact + (1 << 31)) % (1 << 32) - (1 << 31)
    for variant in ("booth", "sbmwc"):
        jout, jcyc = jsa.serial_mac_dot(jnp.asarray(mc), jnp.asarray(ml), bits, variant)
        tout, tcyc = tsa.serial_mac_dot(torch.from_numpy(mc), torch.from_numpy(ml), bits,
                                        variant)
        assert tout.dtype == torch.int32 and tout.shape == ()
        assert int(tout) == int(jout) == wrapped
        assert tcyc == jcyc == (40 + 1) * bits


@pytest.mark.parametrize("bits", range(1, 7))
def test_mac_exhaustive_small_bits(bits):
    """Every pair of ``bits``-bit values at once (one dot product each),
    both variants: the exact products; and a batch of 1000-value dot
    products, cycles per Eq. 8."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    vals = torch.arange(lo, hi + 1, dtype=torch.int32)
    mc, ml = torch.meshgrid(vals, vals, indexing="ij")
    rng = np.random.default_rng(bits)
    a = torch.from_numpy(rng.integers(lo, hi + 1, (8, 1000)).astype(np.int32))
    b = torch.from_numpy(rng.integers(lo, hi + 1, (8, 1000)).astype(np.int32))
    for variant in ("booth", "sbmwc"):
        out, cycles = tsa.serial_mac_dot(mc[..., None], ml[..., None], bits, variant)
        assert torch.equal(out, mc * ml) and cycles == 2 * bits
        dots, cycles = tsa.serial_mac_dot(a, b, bits, variant)
        assert torch.equal(dots.long(), (a.long() * b.long()).sum(dim=-1))
        assert cycles == 1001 * bits


def test_sa_matmul_equals_reference():
    rng = np.random.default_rng(0)
    cfg_t, cfg_j = tsa.SAConfig(16, 4), jsa.SAConfig(16, 4)
    a = rng.integers(-8, 8, (4, 25)).astype(np.int32)
    b = rng.integers(-8, 8, (25, 16)).astype(np.int32)
    for variant in ("booth", "sbmwc"):
        jout, jcyc = jsa.serial_sa_matmul(jnp.asarray(a), jnp.asarray(b), 4, cfg_j, variant)
        tout, tcyc = tsa.serial_sa_matmul(torch.from_numpy(a), torch.from_numpy(b), 4, cfg_t,
                                          variant)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tout.numpy(), a @ b)
        assert tcyc == jcyc == (25 + 1) * 4 + 64
    for sa, zeros in ((jsa, jnp.zeros), (tsa, lambda s, d: torch.zeros(s, dtype=torch.int32))):
        with pytest.raises(ValueError, match="exceeds SA"):
            sa.serial_sa_matmul(zeros((5, 3), jnp.int32), zeros((3, 2), jnp.int32), 4,
                                sa.SAConfig(4, 4))


def test_booth_nonzero_digit_count_equals_reference():
    for bits in range(2, 17):
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        x = np.arange(lo, hi + 1, max((hi - lo) // 4096, 1), dtype=np.int32)
        want = np.asarray(jbp.booth_nonzero_digit_count(jnp.asarray(x), bits))
        got = tbp.booth_nonzero_digit_count(torch.from_numpy(x), bits)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# -- shape cells, inputs, roofline --------------------------------------------


def test_shape_cells_equal_reference():
    assert ARCH_NAMES == JARCHS
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    assert all_cells() == jall_cells()
    for arch, shape in itertools.product(ARCH_NAMES, SHAPES):
        assert cell_applicable(get_config(arch), SHAPES[shape]) == \
            jcell_applicable(jget_config(arch), JSHAPES[shape])


def test_input_specs_and_model_flops_equal_reference():
    for arch, shape, ok, _ in all_cells():
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert roofline.model_flops(cfg, SHAPES[shape]) == \
            jroofline.model_flops(jcfg, JSHAPES[shape])
        if not ok:
            continue
        want = jinput_specs(jcfg, JSHAPES[shape])
        got = input_specs(cfg, SHAPES[shape])
        meta = input_specs(cfg, SHAPES[shape], meta=True)
        assert list(got) == list(want) == list(meta)
        for k, (s, dt) in got.items():
            assert s == tuple(want[k].shape) and str(dt).split(".")[-1] == str(want[k].dtype)
            assert meta[k].is_meta and tuple(meta[k].shape) == s and meta[k].dtype == dt


def test_roofline_terms_and_wire_bytes_equal_reference():
    h = roofline.H100
    jh = JHardwareModel(name=h.name, peak_flops_bf16=h.peak_flops_bf16,
                        peak_flops_int8=h.peak_flops_int8, hbm_bw=h.hbm_bw,
                        link_bw=h.link_bw, hbm_bytes=h.hbm_bytes)
    for chips, flops, nbytes, wire, mf in ((256, 3e18, 2e15, 5e13, 1e18), (1, 1e12, 3e9, 0, 0)):
        t = roofline.Roofline("a", "s", "m", chips, flops, nbytes, wire, mf, hw=h)
        j = jroofline.Roofline("a", "s", "m", chips, flops, nbytes, wire, mf, hw=jh)
        for term in ("compute_s", "memory_s", "collective_s", "step_time_s",
                     "useful_flop_fraction", "mfu"):
            assert getattr(t, term) == pytest.approx(getattr(j, term), rel=1e-12), term
        assert t.bottleneck == j.bottleneck
    for kind, g in itertools.product(KINDS, (1, 2, 4, 16)):
        assert roofline._wire_bytes(kind, 12345.0, g) == jhlo_cost._wire_bytes(kind, 12345.0, g)


def test_per_call_bound_reproduces_kernel_table():
    """Rows 1-3 at the decode gate shape (M=4, K=4096, N=12800: the int8
    activation, 8 Booth planes packed with their sign words, the epilogue's
    scales, the bf16 output) and row 4 at A4 (Sq = Sk = 4096 causal, 32
    query heads of 128)."""
    m, k, n = 4, 4096, 12800
    planes = 2 * 8 * (k // 32) * 4 * n  # magnitude and sign words of 8 planes
    n_bytes = m * k + planes + 4 * m + 4 * n + 2 * m * n
    call = roofline.plan_call(m, k, n, 8, 8, n_bytes=n_bytes)
    ms, by = roofline.bound_ms(call.n_bytes, call.ops)
    assert (round(ms, 4), by) == (0.0314, "bytes")
    a4 = roofline.attention_call(32, roofline.attention_pairs(4096, 4096, True), 128,
                                 n_bytes=0)
    ms, by = roofline.bound_ms(a4.n_bytes, a4.ops, roofline.H100.peak_flops_bf16)
    assert (round(ms, 4), by) == (0.1390, "operations")
    assert roofline.split_products(8, 8) == 1 and roofline.split_products(9, 8) == 2
    assert roofline.split_products(8, 8, a_signed=False) == 2


# -- grad_accum_dtype ----------------------------------------------------------


def test_bf16_gradient_accumulation_matches_reference():
    arch = "granite-3-8b"
    jp = jax.jit(lambda k: jinit(jget(arch), k))(jax.random.PRNGKey(0))
    tp = _port_tree(jp)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jget(arch).vocab_size, (4, 17)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok[:, :-1]), "targets": jnp.asarray(tok[:, 1:])}
    tb = {"tokens": torch.from_numpy(tok[:, :-1]), "targets": torch.from_numpy(tok[:, 1:])}
    jo, to = JOptimConfig(peak_lr=1e-3, total_steps=10), OptimConfig(peak_lr=1e-3,
                                                                      total_steps=10)
    jstep = jax.jit(jmake_step(jget(arch), jo, policy=JPolicy.uniform(8, 8), microbatches=2,
                               grad_accum_dtype=jnp.bfloat16))
    tstep = make_train_step(tget(arch), to, policy=PrecisionPolicy.uniform(8, 8),
                            microbatches=2, grad_accum_dtype="bfloat16")
    jnew, _, jm = jstep(jp, jinit_opt(jget(arch), jo, jp), jb, jnp.int32(0))
    tnew, _, tm = tstep(tp, init_opt_state(tget(arch), to, tp), tb, 0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    jnew = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf).astype(np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jnew)[0]}
    lr0 = to.peak_lr / to.warmup_steps
    for (path, t_new), t_old in zip(tr.flatten_with_path(tnew), tr.leaves(tp)):
        key = tr.path_key(path)
        assert t_new.dtype == t_old.dtype, key
        a, b = jnew[key], t2n(t_new)
        assert (a == b).mean() >= 0.97, key
        bound = 2 * lr0 + 2.0 ** -6 * np.maximum(np.abs(a), np.abs(b))
        assert (np.abs(a - b) <= bound).all(), key


def _port_tree(jp):
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return j2t(np.asarray(node))

    return conv(jp)


# -- the dry run ------------------------------------------------------------------


def _record(tmp_path, arch, shape, multi_pod=False):
    rec = dryrun.run_cell(arch, shape, multi_pod, tmp_path)
    mesh = "2x16x16" if multi_pod else "16x16"
    assert json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json").read_text())["status"] == \
        rec["status"]
    return rec


def _block_bytes(cfg, mesh) -> int:
    """The bytes of rank 0's parameter blocks, from the rules' specs of the
    whole tree's shapes (no tensor of the cell's size)."""
    with sh.use_rules(sh.rules_for_mesh(mesh)):
        params, _ = init_blocks(cfg, torch.Generator(), torch.device("meta"), mesh)
    return sum(t.numel() * t.element_size() for t in tr.leaves(params))


def test_dry_run_production_cells(tmp_path):
    cfg = get_config("granite-3-8b")
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = _record(tmp_path, "granite-3-8b", shape)
        assert rec["status"] == "OK", rec.get("traceback")
        assert rec["chips"] == 256 and rec["memory"]["peak_bytes"] >= \
            rec["memory"]["resident_bytes"] > 0
        assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
        assert set(rec["collectives"]) <= set(KINDS)
        if shape == "train_4k":
            # rank 0 holds its FSDP x TP blocks: 1/256 of the sharded leaves
            mesh = make_dry_mesh((16, 16), ("data", "model"))
            blocks = rec["memory"]["resident_by"]["params"]
            assert blocks == _block_bytes(cfg, mesh)
            whole = sum(t.numel() * 2 for t in tr.leaves(
                _meta_params(cfg)))
            assert blocks < whole / 100
            assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(rec["collectives"])
        else:
            assert rec["calls"]["plan"] > 0
            assert rec["layout"].startswith("tensor parallel over model")
    rec = _record(tmp_path, "granite-3-8b", "decode_32k", multi_pod=True)
    assert rec["status"] == "OK" and rec["chips"] == 512 and rec["rows_per_rank"] == 4
    rec = _record(tmp_path, "hubert-xlarge", "decode_32k")
    assert rec == {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "16x16",
                   "status": "SKIP",
                   "reason": "encoder-only arch has no autoregressive decode step"}


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_prefill_conv_state_owns_its_rows(arch):
    """A one-row prefill's conv state is a copy of the last rows, not a view
    that keeps the whole padded input alive in the cache (the dry run's
    2 x 16 x 16 mamba2 prefill cell, one row a rank, peaked at 39 GiB
    against two rows' 23.5 until this held)."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import init_params

    cfg = tget(arch)
    params = init_params(cfg, torch.Generator(), device="cpu")
    _, cache = make_prefill_step(cfg)(params, torch.zeros((1, 64), dtype=torch.int32))
    convs = [blk["conv"] for blk in cache["layers"] if "conv" in blk]
    assert convs
    for c in convs:
        assert c.untyped_storage().nbytes() == c.numel() * c.element_size()


def _meta_params(cfg):
    from repro_torch.models.transformer import init_params

    return init_params(cfg, torch.Generator(), device="meta")


def test_dry_run_cli_exits_1_on_a_failing_cell(tmp_path, monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(dryrun, "_serve_cell", broken)
    code = dryrun.main(["--arch", "granite-3-8b", "--shape", "decode_32k", "--out",
                        str(tmp_path)])
    assert code == 1
    rec = json.loads((tmp_path / "granite-3-8b__decode_32k__16x16.json").read_text())
    assert rec["status"] == "FAIL" and "injected" in rec["error"] and rec["traceback"]
    assert "[FAIL] granite-3-8b x decode_32k x 16x16" in capsys.readouterr().out


# -- collectives: dry against a real gloo step -----------------------------------------


def _by_kind(calls) -> dict:
    out: dict = {}
    for kind, n_bytes, size, _name in calls:
        slot = out.setdefault(kind, [0, 0, set()])
        slot[0] += 1
        slot[1] += n_bytes
        slot[2].add(size)
    return out


def test_dry_collectives_equal_a_real_gloo_step():
    """The reduced granite step at (2,1) (FSDP), (1,2) (heads and vocab
    parallel) and (1,2) with 3 query heads (context parallel: the query
    rows split), dry on meta tensors and for real over two gloo ranks."""
    from repro_torch.models.transformer import init_params, stack_layers

    arch = "granite-3-8b"
    cases = []
    for shape, over in (((2, 1), {}), ((1, 2), {}), ((1, 2), {"n_heads": 3, "n_kv_heads": 1})):
        cfg = dataclasses.replace(tget(arch), **over)
        gen = torch.Generator()
        gen.manual_seed(0)
        cases.append((shape, over, cfg, stack_layers(cfg, init_params(cfg, gen, device="cpu"))))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, tget(arch).vocab_size, (4, 17)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    real = spawn_ranks(ranks.rank_collectives, 2, device="cpu",
                       args=([(sh_, ov, ranks.to_numpy(full)) for sh_, ov, _, full in cases],
                             arch, batch))
    for (shape, over, cfg, full), calls in zip(cases, real):
        mesh = make_dry_mesh(shape, ("data", "model"))
        params, specs = ranks.blocks_of(tr.tree_map(lambda t: t.to("meta"), full), mesh)
        opt = OptimConfig(kind="adamw", peak_lr=1e-3, total_steps=10)
        step = make_train_step(cfg, opt, mesh=mesh, specs=specs)
        state = init_opt_state(cfg, opt, params)
        mb = {k: torch.from_numpy(v).to("meta") for k, v in batch.items()}
        dry = []
        with recording(lambda *c: dry.append(c)):
            step(params, state, mb, 0)
        assert dry, (shape, over)
        assert _by_kind(dry) == _by_kind(calls), (shape, over)
        assert [c[3] for c in dry] == [c[3] for c in calls], (shape, over)
