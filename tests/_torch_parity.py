"""Helpers shared by the ``test_torch_*`` parity files: move arrays
between the JAX reference and the PyTorch port through numpy (bf16 via
its uint16 bit pattern)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import bitplanes as jbp

# The parity shapes are tiny: one intra-op thread is as fast, and it keeps
# torch's thread pool from spinning against the JAX compiles of other test
# processes on the same cores (that contention slowed these tests ~50x).
torch.set_num_threads(1)


def to_numpy_tree(tree):
    """A JAX pytree as numpy arrays, bf16 leaves as uint16 views."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else np.asarray(a),
        tree,
    )


def j2t(a) -> torch.Tensor:
    """One JAX/numpy array as a CPU tensor (bf16 bit-exact)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def j2t_tree(tree):
    """A JAX parameter dict (one level of nested dicts) as CPU tensors."""
    return {k: j2t_tree(v) if isinstance(v, dict) else j2t(v) for k, v in tree.items()}


def t2n(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy (bf16 widened to float32, exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def packed_to_jax(pt):
    """The reference's PackedPlanes holding the port's words (the words
    are held equal to the reference's own by test_torch_core.py; building
    them with the reference's eager packing compiles every primitive per
    shape, seconds per case)."""
    conv = (lambda t: None if t is None else jnp.asarray(t2n(t)))
    return jbp.PackedPlanes(conv(pt.mag), conv(pt.sign), pt.k, pt.axis, pt.weights,
                            pt.block, conv(pt.occupancy), conv(pt.checksum))


def weight_planes_to_jax(wt):
    """The reference's WeightPlanes holding the port's cache."""
    return jbp.WeightPlanes(
        packed=None if wt.packed is None else packed_to_jax(wt.packed),
        planes=None if wt.planes is None else jnp.asarray(t2n(wt.planes)),
        weights=wt.weights, level=wt.level, variant=wt.variant, w_bits=wt.w_bits,
    )


def quantized_to_jax(tq):
    """The port's quantized tree (an unrolled layer list) as the reference's
    tree, key order kept: the trees are held equal by
    test_torch_serving.py, so parity tests that need the reference's tree
    of the same weights skip its eager quantization."""
    if isinstance(tq, dict):
        return {k: quantized_to_jax(v) for k, v in tq.items()}
    if isinstance(tq, list):
        return [quantized_to_jax(v) for v in tq]
    if isinstance(tq, torch.Tensor):
        return jnp.asarray(t2n(tq), dtype=jnp.bfloat16 if tq.dtype == torch.bfloat16 else None)
    return weight_planes_to_jax(tq)


def reference_layout(cfg, tq):
    """The port's quantized tree in the reference's layout: its layer list
    as the reference's unrolled ``layers``, or stacked into ``periods``
    with a ``tail``."""
    jt = quantized_to_jax(tq)
    if not cfg.scan_layers:
        return jt
    period, n_full = cfg.period_layout()
    plen = len(period)
    layers = jt.pop("layers")
    jt["periods"] = {
        f"b{j}_{kind}": jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *[layers[i * plen + j] for i in range(n_full)])
        for j, kind in enumerate(period)
    }
    jt["tail"] = layers[n_full * plen:]
    return jt


@contextlib.contextmanager
def reference_quantizes_to(make):
    """The reference's engines take ``make()`` (a quantized tree in its
    layout, e.g. the port's through :func:`quantized_to_jax`) in place of
    their eager quantization, which costs seconds per engine."""
    from repro.launch import serve as jserve

    orig = jserve.quantize_params
    jserve.quantize_params = lambda *a, **k: make()
    try:
        yield
    finally:
        jserve.quantize_params = orig


def quantized_paths(tree, path=""):
    """The paths of the stored-quantized linears (``{'w_q', ...}``) of a
    parameter tree of either package."""
    if isinstance(tree, dict):
        if "w_q" in tree:
            return {path}
        return set().union(set(), *[quantized_paths(v, f"{path}/{k}") for k, v in tree.items()])
    if isinstance(tree, (list, tuple)):
        return set().union(set(), *[quantized_paths(v, f"{path}/{i}") for i, v in enumerate(tree)])
    return set()


class StubRunner:
    """Replays like a CUDA graph on the host: capture runs the step on a
    copy of the state (a capture runs nothing on the state) and keeps its
    outputs; a replay reruns it on the state, rewrites those outputs and
    puts the Python counters back, as a graph replay leaves them."""

    def __init__(self, device):
        self.generator = torch.Generator(device=device)
        self.replays = 0

    def warm_up(self, fn):
        fn()

    def capture(self, body, state):
        from repro_torch.launch import graphs

        self.body, self.state = body, state
        self.out = body(graphs.clone_tree(state), self.generator)
        return self.out

    def replay(self):
        from repro_torch.core import plan as plan_mod
        from repro_torch.launch import graphs

        before = graphs.snapshot(plan_mod.DEFAULT_REGISTRY)
        self.out.copy_(self.body(self.state, self.generator))
        graphs.restore(plan_mod.DEFAULT_REGISTRY, before)
        self.replays += 1


class Watch(TorchDispatchMode):
    """Records reads to the host (``_local_scalar_dense``) and tensors built
    from host data (``lift_fresh``) while a step runs."""

    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if "_local_scalar_dense" in name or "lift_fresh" in name:
            self.bad.append(name)
        return func(*args, **(kwargs or {}))


def stub_kernels(monkeypatch):
    """Resolve every plan and attention call to the card's routes, with each
    kernel replaced by a stub of its output's shape (the kernels run only on
    the card): what is left is the Python around them."""
    from repro_torch.kernels import ops, plane_mm, plane_mm_fused, plane_mm_packed
    from repro_torch.layers import attention

    monkeypatch.setattr(ops, "resolve_backend", lambda backend, device=None: "cuda")
    monkeypatch.setattr(attention, "resolve_backend", lambda backend, device=None: "cuda")

    def fused(x_q, packed_w, pw, *, a_scale=None, **kw):
        n = packed_w.mag.shape[-1]
        return torch.zeros((x_q.shape[0], n),
                           dtype=torch.int32 if a_scale is None else torch.bfloat16)

    monkeypatch.setattr(plane_mm_fused, "fused_plane_linear", fused)
    monkeypatch.setattr(plane_mm, "plane_matmul",
                        lambda a, w, pw, **kw: torch.zeros((a.shape[1], w.shape[2]),
                                                           dtype=torch.int32))
    monkeypatch.setattr(plane_mm_packed, "plane_matmul_packed",
                        lambda a, w, pw, **kw: torch.zeros((a.mag.shape[1], w.mag.shape[2]),
                                                           dtype=torch.int32))
    monkeypatch.setattr(attention, "paged_flash_attention",
                        lambda q, *a, **kw: torch.zeros(q.shape, dtype=torch.bfloat16))
