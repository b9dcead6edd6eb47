"""Entry points: ``python -m repro_torch.launch.train`` (the centralized
baseline or the decentralized overlay), ``python -m
repro_torch.launch.ehr_train`` (the EHR training driver) and ``python -m
repro_torch.launch.serve`` (batched decode serving)."""
