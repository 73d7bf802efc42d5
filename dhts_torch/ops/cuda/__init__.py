"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel's source lives in ``csrc/`` with a plain C interface; it is
built with ``nvcc`` at first launch (:mod:`dhts_torch.ops.cuda._build`) and
bound with ``ctypes``. Importing these modules touches no GPU and needs no
compiler.

    itscp_hybrid_episode   K1: the fused ITSCP hybrid episode, forward (hard,
                           soft, straight-through) and backward
"""
