"""Launch-side tooling of the port.

:mod:`repro_torch.launch.roofline` — the Big-means half of the
reference's ``repro.launch.roofline`` (roofline terms and the fused-chunk
traffic model) with the H100's published peaks.  The reference's XLA
dry-run and HLO tools are not ported.
"""
