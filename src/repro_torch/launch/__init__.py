"""Launch layer: the LM serving and training entry points (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``),
their train, prefill and decode steps (on one device, or over a mesh as
DTensors: :mod:`.steps`, :mod:`.spmd`), the ambient mesh context, the
local and production meshes (:mod:`.mesh`), the sharding rules
(:mod:`.sharding`), the tuning knobs, and the dry run on a fake process
group (``python -m repro_torch.launch.dryrun``) with its roofline
analysis (:mod:`.analysis`)."""
