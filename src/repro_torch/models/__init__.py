"""repro_torch.models — the LM inference path (dense attention configs):
``layers``, ``attention`` (its ``chunked_attention`` runs the port's flash
attention kernel), ``transformer`` and ``model.Model``; and ``tiny``, the
numpy-only descriptions of the paper's IC and CNV conv models."""
