"""Launch layer: the LM serving entry point (``python -m
repro_torch.launch.serve``), its decode step, the ambient mesh context
and the tuning knobs.  The production mesh, sharding, the train step,
the dry-run and its analysis come with later slices (ROADMAP §1)."""
