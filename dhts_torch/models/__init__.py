"""State, scene and step functions (counterpart of :mod:`dhts.models`).

* :mod:`dhts_torch.models.vehicle`    — per-vehicle IDM parameter sets
* :mod:`dhts_torch.models.scene`      — host-side scene builder -> SceneSpec
* :mod:`dhts_torch.models.network`    — NetworkState + network_step
* :mod:`dhts_torch.models.conversion` — macro<->micro events as masked ops
* :mod:`dhts_torch.models.lane`       — single-lane rollouts (inverse problems)
"""
