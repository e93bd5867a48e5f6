"""Launch-side tooling of the port.

:mod:`repro_torch.launch.roofline` — the reference's
``repro.launch.roofline`` (roofline terms, the fused-chunk traffic model
and ``model_flops``) with the H100's published peaks; its ``main`` (a
projection of the reference's TPU benchmark file) is not ported.
:mod:`repro_torch.launch.train` — the clustering launcher.  The dry-run
and HLO tools (``dryrun``, ``specs``, ``mesh``, ``perf``, ``report``,
``hlo_analysis``, ``hlo_profile``), which lower the train step of
``repro_torch.train``, are still to be ported.
"""
