"""repro_torch.models — the LM inference path (dense attention configs):
``layers``, ``attention`` (its ``chunked_attention`` runs the port's flash
attention kernel), ``transformer`` and ``model.Model``."""
