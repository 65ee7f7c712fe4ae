"""Training the SSM and hybrid families on a ``(data, model)`` mesh of
gloo ranks, against one device and the reference.

Reduced mamba2-1.3b and recurrentgemma-2b, three AdamW steps from the
reference's weights on meshes (2,1) and (1,2). Their mixers (the SSD, the
RG-LRU and its convolution) run whole on every rank of the model row with
their weights gathered; their MLPs and the vocab head are tensor
parallel; recurrentgemma's windowed attention, whose query heads do not
divide the model axis and whose window does not allow a split of the
query rows, runs whole too. Tolerances as ``tests/test_torch_mesh_train.py``:
the first step's loss within ``FIRST_LOSS_RTOL`` and grad norm within
``FIRST_GNORM_RTOL`` of the port's one-device step and of the reference's
compiled one, every step within the reference's 2e-2 between meshes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch.steps import init_opt_state as jinit_opt, make_train_step as jmake_step
from repro.models.transformer import init_params as jinit
from repro.optim import OptimConfig as JOptimConfig
from repro_torch.configs import get_reduced as tget
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.steps import init_opt_state, make_train_step
from repro_torch.optim import OptimConfig

import _torch_mesh_ranks as ranks
from _torch_parity import to_numpy_tree

FIRST_LOSS_RTOL = 5e-4
FIRST_GNORM_RTOL = 2e-3
THREE = dict(rtol=2e-2, atol=2e-2)
STEPS, B, S = 3, 4, 16
ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")
CASES = [(a, m) for a in ARCHS for m in ((2, 1), (1, 2))]
_CACHE: dict = {}


def _weights(arch):
    if arch not in _CACHE:
        jp = jax.jit(lambda k: jinit(jget(arch), k))(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        batches = []
        for _ in range(STEPS):
            tok = rng.integers(0, jget(arch).vocab_size, (B, S + 1)).astype(np.int32)
            batches.append({"tokens": tok[:, :-1], "targets": tok[:, 1:]})
        _CACHE[arch] = (jp, to_numpy_tree(jp), batches)
    return _CACHE[arch]


def _sharded(case):
    if "runs" not in _CACHE:
        args = [dict(shape=shape, arch=arch, cfg_over={}, params_np=_weights(arch)[1],
                     batches=_weights(arch)[2], opt_kind="adamw", w_bits=0)
                for arch, shape in CASES]
        _CACHE["runs"] = dict(zip(CASES, spawn_ranks(ranks.rank_train_cases, 2, device="cpu",
                                                     args=(args,))))
    return _CACHE["runs"][case]


def _one_device(arch):
    key = ("one", arch)
    if key not in _CACHE:
        jp, pn, batches = _weights(arch)
        kw = dict(peak_lr=1e-3, total_steps=10)
        step = make_train_step(tget(arch), OptimConfig(**kw))
        params = ranks.to_torch(pn)
        state = init_opt_state(tget(arch), OptimConfig(**kw), params)
        port = ([], [])
        for i, b in enumerate(batches):
            params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in
                                                    b.items()}, i)
            port[0].append(float(m["loss"]))
            port[1].append(float(m["grad_norm"]))
        jopt = JOptimConfig(**kw)
        jstep = jax.jit(jmake_step(jget(arch), jopt, policy=JPolicy.off()))
        js, ref, p = jinit_opt(jget(arch), jopt, jp), ([], []), jp
        for i, b in enumerate(batches):
            p, js, m = jstep(p, js, {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(i))
            ref[0].append(float(m["loss"]))
            ref[1].append(float(m["grad_norm"]))
        _CACHE[key] = (port, ref)
    return _CACHE[key]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_family_training_on_a_mesh_equals_one_device_and_reference(case):
    got = _sharded(case)
    for name, (losses, gnorms) in zip(("port", "reference"), _one_device(case[0])):
        assert got["losses"][0] == pytest.approx(losses[0], rel=FIRST_LOSS_RTOL), name
        assert got["gnorms"][0] == pytest.approx(gnorms[0], rel=FIRST_GNORM_RTOL), name
        np.testing.assert_allclose(got["losses"], losses, **THREE, err_msg=name)
        np.testing.assert_allclose(got["gnorms"], gnorms, **THREE, err_msg=name)
