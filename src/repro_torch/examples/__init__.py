"""The paper's example scenarios on the port: each module runs as
``python -m repro_torch.examples.<name>`` (on the GPU unless ``--device
cpu``) and prints what the reference's ``examples/<name>.py`` prints.

* :mod:`.quickstart` — exact bit-serial matmul, the serial MAC's cycles,
  the systolic throughput model, a w8a8 forward;
* :mod:`.serve_quantized` — the lockstep engine dense, at 8/6/4 bits from
  one stored 8-bit decomposition, on both MAC variants and both levels;
* :mod:`.precision_sweep` — KL(dense || quantized) at 16 to 1 bits, a
  per-layer mixed policy and the runtime dial;
* :mod:`.train_tiny_lm` — a small LM trained (QAT optional) with
  checkpoints; its loss must fall.

Each splits into ``main(argv=None)`` and a function of the model (config,
parameters, device) that prints the script's lines and returns its
numbers, which tests and the GPU smoke run call.
"""

from repro_torch.core import plan as _plan
from repro_torch.launch import graphs as _graphs


def counted(fn):
    """``fn()``, the plan routes it called and the kernels it launched (those
    launched at least once): what a decode step replayed from a CUDA graph
    tallies too."""
    before = _graphs.snapshot(_plan.DEFAULT_REGISTRY)
    out = fn()
    inc = _graphs.delta(before, _graphs.snapshot(_plan.DEFAULT_REGISTRY))
    return out, dict(inc["routes"]), {k: v for k, v in inc["launches"].items() if v}
