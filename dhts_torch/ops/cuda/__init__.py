"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel's source lives in ``csrc/`` with a plain C interface; it is
built with ``nvcc`` at first launch (:mod:`dhts_torch.ops.cuda._build`) and
bound with ``ctypes``. Importing these modules touches no GPU and needs no
compiler.

    itscp_hybrid_episode   K1: the fused ITSCP hybrid episode, forward (hard,
                           soft, straight-through) and backward
    macro_rollout          K2: the fused ARZ macro-lane rollout of the
                           inverse-macro benchmark, forward and backward
    micro_rollout          K3: the fused IDM platoon rollout of the
                           inverse-micro benchmark, forward and backward

The sources share ``csrc/dhts_scalar.cuh`` (the dual number of the
forward-mode backwards, the ARZ Riemann solver, the IDM step).
"""
