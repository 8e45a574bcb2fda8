"""Launch layer: the LM serving and training entry points (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``),
their decode and train steps, the ambient mesh context, the local mesh
(:mod:`.mesh`) and the tuning knobs.  The production mesh, sharding,
the dry-run and its analysis come with later slices (ROADMAP §1)."""
