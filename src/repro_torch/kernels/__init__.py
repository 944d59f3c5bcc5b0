"""Hand-written CUDA kernels for FedDD's hot spots (sources in ``../csrc``).

  importance    fused |dW (W+dW)/W|, per-channel reduction, sqrt and
                coverage division, Eq. (20)/(21)              (Step 2)
  sparse_agg    masked weighted (num, den) over stacked clients,
                Eq. (4), or in its mean mode the finished
                Eq. (4) with the previous-global fill        (Step 4)
  masked_merge  Eq. (5) client update, a blend of global and
                local by channel, every leaf in one launch    (Step 7)
  flash_attention  causal / sliding-window GQA attention with an
                online softmax, for the LM stack's long-sequence prefill
  conv          SAME convolutions of a fleet whose weights carry a
                client dimension (vmapped local SGD): forward, input
                and weight gradients, one launch a pass

Each kernel has ``ref.py`` (the plain PyTorch version) and ``ops.py``
(the wrapper): a CPU tensor goes to ``ref.py``, a CUDA tensor to the
kernel, anything else raises (``conv`` routes inside its ``vmap``
rules, its CPU route the vmapped ``F.conv2d``).  ``launch_counts``
reports how many times each kernel was launched since
``reset_launch_counts``.
"""

from repro_torch.kernels._lib import (KERNELS, build, launch_counts,
                                      reset_launch_counts)

__all__ = ["KERNELS", "build", "launch_counts", "reset_launch_counts"]
