"""repro_torch.serve — the serving side of the port. So far only the
failure types the executor's ``submit_wave`` raises (``faults``); the
router, replicas and fault injection come with the serving slice."""
