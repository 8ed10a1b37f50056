"""Launchers: the step factories (`steps`), the training loop (`train`,
`python -m repro_torch.launch.train`) and the serving scheduler (`serve`,
`python -m repro_torch.launch.serve`)."""
