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
    itscp_macro_episode    K4: the fused all-macro ITSCP episode, forward
                           and backward with respect to the action and the
                           initial state (r0, y0)
    itscp_spatial_step     K6's STEP body: one step of the fused spatial
                           ITSCP episode on one lane shard, forward (hard,
                           soft) and forward-mode derivative, one launch per
                           step, B episodes per launch
    dkernel                K5: the differentiable kernel op template
                           (CUDA forward and derivative, plain body)

The sources share ``csrc/dhts_scalar.cuh`` (the dual number of the
forward-mode backwards, the ARZ Riemann solver, the IDM step); K1, K4 and
the STEP body share the per-lane phases of an ITSCP step in
``csrc/itscp_step.cuh``.
"""
