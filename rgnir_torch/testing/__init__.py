"""Checks that operators run on a machine: the kernel self-test
(``python -m rgnir_torch.testing.selftest``)."""
