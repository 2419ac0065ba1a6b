"""Measuring tools of the port that run on the card (``python -m
instant_nsr_pl_tpu_torch.tools.<name>``)."""
