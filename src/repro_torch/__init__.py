"""PyTorch + CUDA port of the bit-serial matrix multiplication reproduction.

The package keeps the layer map of the JAX reference (``src/repro``), so
each module's counterpart is found by path:

* ``configs/``  — architecture registry (dense configs of this slice);
* ``core/``     — precision policy, quantization, bit/digit-plane
  decompositions, packed plane words, execution plans;
* ``kernels/``  — hand-written Hopper CUDA kernels (``csrc/``), their
  ctypes wrappers and the plain PyTorch version beside each;
* ``layers/``   — quantized linear, norms, rotary, embedding, MLP,
  attention over an int8 KV cache;
* ``models/``   — model config, parameter init and transfer, weight
  quantization with the plane cache, KV cache, the transformer forward;
* ``runtime/``  — the host-side slot scheduler;
* ``launch/``   — sampling, prefill/decode steps and the
  continuous-batching engine with its CLI.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
