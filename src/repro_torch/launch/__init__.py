"""Launchers: the step factories (`steps`) and the serving scheduler
(`serve`, `python -m repro_torch.launch.serve`)."""
