"""Launch layer of the port: meshes, cells, the dry run, the roofline and
the train/serve CLIs (``python -m repro_torch.launch.serve``).

Nothing here is imported by the package itself: ``launch.dryrun`` sets up
its fake process group only when ``run_cell`` or ``main`` runs."""
