"""Launch-side tooling of the port.

:mod:`repro_torch.launch.roofline` — roofline terms, the fused-chunk
traffic model and ``model_flops`` with the H100's published peaks; its
``main`` projects chunk rates measured on the card.
:mod:`repro_torch.launch.train` — the clustering launcher.
The dry run (:mod:`~repro_torch.launch.dryrun`) counts one step of every
(arch x shape) cell on the production mesh without running it: DTensors of
fake tensors over a fake process group (:mod:`~repro_torch.launch.mesh`),
placed by the sharding rules (:mod:`~repro_torch.launch.specs`), counted
op by op (:mod:`~repro_torch.launch.hlo_analysis`,
:mod:`~repro_torch.launch.hlo_profile`); :mod:`~repro_torch.launch.perf`
reruns a cell under the model switches and
:mod:`~repro_torch.launch.report` renders the records.
"""
