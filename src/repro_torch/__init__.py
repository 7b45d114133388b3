"""PyTorch/CUDA port of the MCMA decode-serving path, the xLSTM
family's prefill and decode, the training path of both (the MCMA
co-training in the LM train step, AdamW, the Trainer and checkpoints),
and the paper pipeline (``core/``: one-pass, iterative, MCCA and MCMA
co-training of the benchmark apps, quality metrics, the NPU cost model).

A second package beside the JAX reference (``repro``), with the same
layout: ``repro/<pkg>/<mod>.py`` has its counterpart at
``repro_torch/<pkg>/<mod>.py``, with the same public names and argument
order.  It never imports ``jax`` or anything of ``repro``.  Every Pallas
kernel of the reference is a hand-written CUDA C++ kernel here
(``kernels/csrc/``), each with its PyTorch version beside its wrapper.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no ``device`` they raise.

The dispatch ``backend`` strings keep the reference's names:
  * ``"pallas"``       -> the switched CUDA kernel
                          (kernels/switched_mlp.py, csrc/switched_mlp.cu);
  * ``"pallas_fused"`` -> the fused CUDA kernel
                          (kernels/fused_dispatch.py, csrc/fused_dispatch.cu);
  * ``"xla"``          -> the eager per-class oracle loop
                          (runtime/dispatch.execute_dispatch).
On CPU tensors the two kernel backends run each kernel's PyTorch version.
Float32 products stay in full float32 on the GPU
(``torch.backends.cuda.matmul.allow_tf32`` is left False; the launchers
set it).
"""
