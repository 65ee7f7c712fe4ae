"""Training on a ``(data, model)`` mesh of gloo ranks against one device
and against the reference.

The port's sharded step (``make_train_step(mesh=, specs=)``: FSDP over
data, tensor and expert parallel over model, the optimizer state in
blocks) runs three steps of reduced granite-3-8b and qwen3-moe-235b-a22b
from the reference's weights on meshes (2,1), (1,2) and (2,2), with AdamW
and Adafactor, one QAT run (w8a8) at (1,2), one with compressed
gradients and one with two microbatches at (2,1), and granite with 3
query heads at (1,2) (the heads do not divide: context parallel).
Tolerances:

* the first step differs from one device only in the order of its sums
  (gradients reduced over ranks; a row-parallel projection's partial
  products, each rounded to bf16 as the product returns it, summed in
  float32): the loss within ``FIRST_LOSS_RTOL`` (measured up to 2.1e-4 at
  (1,2)) and the grad norm within ``FIRST_GNORM_RTOL`` of the port's
  one-device step and of the reference's compiled one-device step. Under
  QAT a partial sum rounded otherwise can move a value across a rounding
  step of the next quantizer: ``QAT_LOSS_RTOL`` / ``QAT_GNORM_RTOL``
  (measured 6.3e-4 / 2.2e-3 at (1,2); without the row-parallel amax
  reduction the grad norm moves 1.2e-2). With several data ranks the
  MoE aux loss is the reference's on a mesh, each data rank's own over
  its rows averaged over the data axis: the first loss is held against
  the one-device cross entropy plus that aux, and its grad norm (whose
  aux term differs) within the three-step bound;
* all three steps within the reference's own bound between meshes,
  rtol = atol = 2e-2 (``tests/test_distribution.py``), of both.

The MoE runs use ``capacity_factor=0`` (dropless): with capacity the
dropped copies depend on the mesh, which ``tests/test_torch_moe_ep.py``
holds against the reference on the same mesh.

A checkpoint written at (2,2) restores bit-equal at (1,1), at (4,1)
through ``ElasticMesh``, and in the reference trainer's
``CheckpointManager``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_reduced as jget
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch.steps import init_opt_state as jinit_opt, make_train_step as jmake_step
from repro.models.transformer import init_params as jinit
from repro.optim import OptimConfig as JOptimConfig
from repro_torch.configs import get_reduced as tget
from repro_torch.core import tree as tr
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.steps import init_opt_state, make_train_step
from repro_torch.launch.train import TrainRun
from repro_torch.optim import OptimConfig

import _torch_mesh_ranks as ranks
from _torch_parity import to_numpy_tree

FIRST_LOSS_RTOL = 5e-4
FIRST_GNORM_RTOL = 2e-3
QAT_LOSS_RTOL = 1e-3
QAT_GNORM_RTOL = 5e-3
THREE = dict(rtol=2e-2, atol=2e-2)
STEPS, B, S = 3, 4, 16
GRANITE, QWEN = "granite-3-8b", "qwen3-moe-235b-a22b"
#: granite with 3 query heads and 1 KV head: at model 2 the heads do not
#: divide and the query rows are split (context parallel)
GRANITE_3H = "granite-3-8b/3-heads"
ARCH = {GRANITE: GRANITE, QWEN: QWEN, GRANITE_3H: GRANITE}
OVER = {GRANITE: {}, QWEN: {"moe_capacity_factor": 0.0},
        GRANITE_3H: {"n_heads": 3, "n_kv_heads": 1}}

#: (model, mesh, optimizer, w_bits, microbatches, compressed gradients)
CASES = [
    (GRANITE_3H, (1, 2), "adamw", 0, 1, False),
    (GRANITE, (2, 1), "adamw", 0, 1, False),
    (GRANITE, (1, 2), "adamw", 0, 1, False),
    (GRANITE, (2, 2), "adamw", 0, 1, False),
    (GRANITE, (2, 2), "adafactor", 0, 1, False),
    (GRANITE, (1, 2), "adamw", 8, 1, False),
    (GRANITE, (2, 1), "adamw", 0, 1, True),
    (GRANITE, (2, 1), "adamw", 0, 2, False),
    (QWEN, (2, 1), "adamw", 0, 1, False),
    (QWEN, (1, 2), "adamw", 0, 1, False),
    (QWEN, (1, 2), "adafactor", 0, 1, False),
    (QWEN, (2, 2), "adamw", 0, 1, False),
]
_CACHE: dict = {}


def _weights(arch):
    key = ("w", arch)
    if key not in _CACHE:
        jc = dataclasses.replace(jget(ARCH[arch]), **OVER[arch])
        jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        batches = []
        for _ in range(STEPS):
            tok = rng.integers(0, jc.vocab_size, (B, S + 1)).astype(np.int32)
            batches.append({"tokens": tok[:, :-1], "targets": tok[:, 1:]})
        _CACHE[key] = (jc, jp, to_numpy_tree(jp), batches)
    return _CACHE[key]


def _sharded(case):
    """Every case's sharded run: one spawn per world size, cached."""
    if "runs" not in _CACHE:
        runs = {}
        for world in (2, 4):
            todo = [c for c in CASES if c[1][0] * c[1][1] == world]
            args = []
            for arch, shape, opt, bits, mb, comp in todo:
                _, _, pn, batches = _weights(arch)
                args.append(dict(shape=shape, arch=ARCH[arch], cfg_over=OVER[arch], params_np=pn,
                                 batches=batches, opt_kind=opt, w_bits=bits,
                                 microbatches=mb, compress=comp))
            for c, r in zip(todo, spawn_ranks(ranks.rank_train_cases, world, device="cpu",
                                              args=(args,))):
                runs[c] = r
        _CACHE["runs"] = runs
    return _CACHE["runs"][case]


def _one_device(arch, opt, bits, mb, comp):
    """(losses, grad norms) of the port's one-device step, and of the
    reference's compiled one-device step."""
    key = ("one", arch, opt, bits, mb, comp)
    if key not in _CACHE:
        jc, jp, pn, batches = _weights(arch)
        tc = dataclasses.replace(tget(ARCH[arch]), **OVER[arch])
        kw = dict(kind=opt, peak_lr=1e-3, total_steps=10)
        tpol = PrecisionPolicy.uniform(bits, bits) if bits else PrecisionPolicy.off()
        step = make_train_step(tc, OptimConfig(**kw), policy=tpol, microbatches=mb,
                               compress_grads=comp)
        params = ranks.to_torch(pn)
        state = init_opt_state(tc, OptimConfig(**kw), params, comp)
        port = ([], [])
        for i, b in enumerate(batches):
            params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in
                                                    b.items()}, i)
            port[0].append(float(m["loss"]))
            port[1].append(float(m["grad_norm"]))
        jpol = JPolicy.uniform(bits, bits) if bits else JPolicy.off()
        jopt = JOptimConfig(**kw)
        jstep = jax.jit(jmake_step(jc, jopt, policy=jpol, microbatches=mb,
                                   compress_grads=comp))
        js, ref = jinit_opt(jc, jopt, jp, comp), ([], [])
        for i, b in enumerate(batches):
            jp_, js, m = jstep(jp if i == 0 else jp_, js,
                               {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(i))
            ref[0].append(float(m["loss"]))
            ref[1].append(float(m["grad_norm"]))
        _CACHE[key] = (port, ref, params)
    return _CACHE[key]


def _mesh_first_loss(arch, data):
    """The first step's loss on ``data`` data ranks of an MoE model, both
    packages' one-device forward: the cross entropy of the whole batch
    plus 0.01 times the mean over the row blocks of each block's aux."""
    from repro.models.transformer import loss_fn as jloss_fn
    from repro_torch.models.transformer import loss_fn

    jc, jp, pn, batches = _weights(arch)
    tc = dataclasses.replace(tget(ARCH[arch]), **OVER[arch])
    params = ranks.to_torch(pn)
    b = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jl = jax.jit(lambda p, bb: jloss_fn(jc, p, bb)[1])
    with torch.no_grad():
        ce = float(loss_fn(tc, params, b)[1]["loss"])
        aux = np.mean([float(loss_fn(tc, params, {k: v[i * B // data:(i + 1) * B // data]
                                                  for k, v in b.items()})[1]["aux_loss"])
                       for i in range(data)])
    jce = float(jl(jp, jb)["loss"])
    jaux = np.mean([float(jl(jp, {k: v[i * B // data:(i + 1) * B // data]
                                  for k, v in jb.items()})["aux_loss"]) for i in range(data)])
    return ce + 0.01 * aux, jce + 0.01 * jaux


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)) if isinstance(
    c, tuple) else str(c))
def test_sharded_training_equals_one_device_and_reference(case):
    arch, shape, opt, bits, mb, comp = case
    got = _sharded(case)
    port, ref, one_params = _one_device(arch, opt, bits, mb, comp)
    moe_rows = arch == QWEN and shape[0] > 1
    firsts = _mesh_first_loss(arch, shape[0]) if moe_rows else (port[0][0], ref[0][0])
    lrt, grt = (QAT_LOSS_RTOL, QAT_GNORM_RTOL) if bits else (FIRST_LOSS_RTOL, FIRST_GNORM_RTOL)
    for name, (losses, gnorms), first in zip(("port", "reference"), (port, ref), firsts):
        assert got["losses"][0] == pytest.approx(first, rel=lrt), name
        if not moe_rows:
            assert got["gnorms"][0] == pytest.approx(gnorms[0], rel=grt), name
        np.testing.assert_allclose(got["losses"], losses, **THREE, err_msg=name)
        np.testing.assert_allclose(got["gnorms"], gnorms, **THREE, err_msg=name)
    # the gathered tree is the reference's, leaf for leaf
    keys = [tr.path_key(p) for p, _ in tr.flatten_with_path(one_params)]
    assert [tr.path_key(p) for p, _ in tr.flatten_with_path(got["params"])] == keys
    for a, b in zip(tr.leaves(got["params"]), tr.leaves(one_params)):
        assert tuple(a.shape) == tuple(b.shape)
    # each rank held blocks of the optimizer state: smaller than the whole
    whole = sum(int(np.prod(p.shape)) for p in tr.leaves(one_params))
    held = sum(int(np.prod(s)) for s in got["state_shapes"])
    per = 2 if opt == "adamw" else 0
    if per:
        assert held < per * whole + (whole if comp else 0)


def test_checkpoint_crosses_meshes_and_packages(tmp_path):
    """Saved at (2,2) by rank 0 (the whole tree); restored at (4,1)
    through ``ElasticMesh``, at (1,1) and by the reference's manager:
    every parameter bit-equal."""
    cfg = tget(GRANITE)
    kw = dict(cfg=cfg, steps=2, global_batch=4, seq_len=16, device="cpu", log_every=100,
              ckpt_dir=str(tmp_path), ckpt_every=100)
    saved = TrainRun(**kw, model_axis=2, ranks=4).run()
    assert saved["mesh"] == {"data": 2, "model": 2}
    elastic = TrainRun(**kw, model_axis=1, ranks=4).run()  # resumes at step 2: no step left
    assert elastic["losses"] == [] and elastic["mesh"] == {"data": 4, "model": 1}
    one = TrainRun(**kw).run()  # one device
    assert one["losses"] == []
    jc = jget(GRANITE)
    jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(0))
    template = {"params": jp, "opt": jinit_opt(jc, JOptimConfig(), jp)}
    jstate, meta = JCheckpointManager(str(tmp_path)).restore(template)
    assert meta["step"] == 1
    for (path, a), b, c in zip(tr.flatten_with_path(saved["params"]),
                               tr.leaves(elastic["params"]), tr.leaves(one["params"])):
        key = tr.path_key(path)
        assert torch.equal(a, b) and torch.equal(a, c.cpu()), key
        ref = np.asarray(_lookup(jstate["params"], path))
        got = a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 \
            else a.numpy()
        assert np.array_equal(ref.view(got.dtype) if ref.dtype != got.dtype else ref, got), key


def test_a_step_failing_on_one_rank_fails_every_rank_at_once():
    """Rank 0's second step raises before its first collective while rank 1
    waits inside its own (an all-gather): rank 0 aborts the process group
    instead of entering another collective, and the run raises within
    seconds, not at the collectives' 600 s timeout."""
    import time

    run = TrainRun(cfg=tget(GRANITE), steps=3, global_batch=4, seq_len=16, device="cpu",
                   log_every=100)
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="injected failure on rank 0") as err:
        spawn_ranks(ranks.rank_fail_on_rank0, 2, device="cpu", args=(run, 1))
    assert "process group was aborted" in str(err.value)
    assert time.perf_counter() - t0 < 120


def _lookup(tree, path):
    for p in path:
        tree = tree[p]
    return tree
