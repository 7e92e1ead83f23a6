"""PyTorch + CUDA port of the path tracer (a second package beside the
JAX reference ``cuda_optix_pathtracing_tpu``).

Layout mirrors the reference (``ops/ models/ scene/ utils/``), so every
module has one counterpart there. Plain tensor code is PyTorch; every
Pallas kernel of the reference becomes a hand-written CUDA kernel for
Hopper (``csrc/*.cu``, built with ``nvcc`` at first use). Each kernel's
wrapper launches it for CUDA tensors and runs its plain PyTorch version
for CPU tensors.

Entry points (``render``, ``render_progressive``, ``trace_paths``,
``utils.cli.main``) default to ``device="cuda"`` and raise when no card is
present, unless the caller asks for ``device="cpu"``.

Precision: f32 matrix products must never drop to TF32 (the GPU form of
the bf16 ray-quantisation fault in ``docs/quality.md``), so both switches
are pinned off at import, and every 4×4 transform is written as explicit
f32 multiply-adds.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
