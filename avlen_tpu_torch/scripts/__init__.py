"""The port's data CLIs, run with ``python -m avlen_tpu_torch.scripts.<name>``
(counterparts of the repo's ``scripts/`` of the same names)."""
