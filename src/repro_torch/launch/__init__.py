"""Launchers: the step factories (`steps`), the training loop (`train`,
`python -m repro_torch.launch.train`), the serving scheduler (`serve`,
`python -m repro_torch.launch.serve`), meshes (`mesh`, logical or of
ranks) and process groups with rank launch (`distributed`)."""
