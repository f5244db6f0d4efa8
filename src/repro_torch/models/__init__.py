"""repro_torch.models — the LM (dense attention configs), inference and
training: ``layers``, ``attention`` (its ``chunked_attention`` runs the
port's flash attention kernel and, under autograd, its backward kernel),
``transformer`` (remat) and ``model.Model``; and ``tiny``, the
numpy-only descriptions of the paper's IC and CNV conv models."""
