"""Entry points: ``python -m repro_torch.launch.train`` (the centralized
baseline or the decentralized overlay) and ``python -m
repro_torch.launch.ehr_train`` (the EHR training driver)."""
