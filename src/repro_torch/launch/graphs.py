"""Compiled serving steps: a step function captured once as a CUDA graph on
static buffers and replayed.

The reference compiles its serving steps with ``jax.jit`` and keys them by
precision (``src/repro/launch/serve.py:701-728``). The port's counterpart
for the decode step is a CUDA graph: :class:`CapturedStep` runs the step
once on copies of the engine's static buffers (the warm-up builds every
lazily made constant, plan and library, and advances none of the engine's
state), captures one run on the buffers themselves, and replays it. A
replay runs the captured kernels on whatever the buffers hold; the step's
outputs are static tensors of the graph's private memory pool, rewritten
by every replay. The step must read nothing back to the host and build no
tensor from host data (capture refuses both), and each step function gets
its own pool.

Python runs only at capture, so what Python counts — the plan registry's
calls per route and the kernel wrappers' ``launches`` — moves only then.
:class:`CapturedStep` records each counter's increment over the capture
(:func:`snapshot`, :func:`delta`), puts the counters back, and adds the
increment at every replay (:func:`add`), so the counts mean what they mean
for the eager step. A capture or replay error raises; nothing falls back
to the eager step.

The runner is the CUDA graph itself (:class:`CudaGraphRunner`): its
``warm_up(fn)`` runs ``fn`` once, ``capture(body, state)`` captures
``body(state, generator)`` and returns its outputs without running it, and
``replay()`` reruns what it captured. The tests substitute one that reruns
the step on the host and puts the counters back, as a replay leaves them.
"""

from __future__ import annotations

import collections
import time
from typing import Callable

import torch


def launch_counters() -> dict[str, Callable]:
    """The kernel wrappers that count their launches (``.launches``)."""
    from repro_torch.kernels import flash_attention, fold, plane_mm, plane_mm_fused, plane_mm_packed

    return {
        "fused_plane_linear": plane_mm_fused.fused_plane_linear,
        "plane_matmul": plane_mm.plane_matmul,
        "plane_matmul_packed": plane_mm_packed.plane_matmul_packed,
        "flash_attention": flash_attention.flash_attention,
        "paged_flash_attention": flash_attention.paged_flash_attention,
        "fold": fold.fold_leaves,
    }


def snapshot(registry) -> dict:
    """The plan registry's route calls and every wrapper's launches."""
    return {"routes": collections.Counter(registry.calls),
            "launches": {name: fn.launches for name, fn in launch_counters().items()}}


def delta(before: dict, after: dict) -> dict:
    routes = collections.Counter(after["routes"])
    routes.subtract(before["routes"])
    return {"routes": +routes,
            "launches": {k: after["launches"][k] - before["launches"][k]
                         for k in after["launches"]}}


def add(registry, inc: dict) -> None:
    registry.calls.update(inc["routes"])
    for name, fn in launch_counters().items():
        fn.launches += inc["launches"].get(name, 0)


def restore(registry, snap: dict) -> None:
    registry.calls.clear()
    registry.calls.update(snap["routes"])
    for name, fn in launch_counters().items():
        fn.launches = snap["launches"][name]


def clone_tree(tree):
    """A copy of a tree (dicts, lists, tuples) of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


class CudaGraphRunner:
    """Capture and replay through ``torch.cuda.CUDAGraph``. The step's
    random numbers come from ``generator``, registered with the graph:
    seeding it before a replay seeds that replay's draws."""

    def __init__(self, device: torch.device):
        self.device = device
        self.generator = torch.Generator(device=device)
        self.graph = None

    def warm_up(self, fn: Callable) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):  # off the capture stream, as capture asks
            fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)

    def capture(self, body: Callable, state):
        """Capture ``body(state, generator)``; nothing runs until a replay."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph):
            out = body(state, self.generator)
        self.graph = graph
        return out

    def replay(self) -> None:
        self.graph.replay()


class CapturedStep:
    """``body(state, gen) -> outputs`` captured once on the static tensors
    of ``state`` (a tree) and replayed by :meth:`__call__`, which returns the
    same static outputs each time. ``registry`` is the plan registry whose
    route calls the replays add to. With ``collector`` (the step's ABFT
    collector) ``keys`` are the plan keys of the alarm flags the capture
    reported, in the order every replay rewrites them. ``capture_s`` is the
    warm-up and capture's host time."""

    def __init__(self, body: Callable, state, registry, runner, collector=None):
        self.registry = registry
        self.runner = runner
        t0 = time.perf_counter()
        before = snapshot(registry)
        scratch = clone_tree(state)
        runner.warm_up(lambda: body(scratch, runner.generator))
        del scratch
        restore(registry, before)
        try:
            self.outputs = runner.capture(body, state)
            self.increment = delta(before, snapshot(registry))
        finally:
            restore(registry, before)
        self.keys = None if collector is None else list(collector.keys)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, seed: int):
        """Replay with the step's generator seeded by ``seed``."""
        self.runner.generator.manual_seed(seed)
        self.runner.replay()
        add(self.registry, self.increment)
        return self.outputs
