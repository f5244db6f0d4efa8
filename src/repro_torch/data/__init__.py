"""repro_torch.data — the synthetic stand-in datasets (``synthetic``), a
numpy-only copy of ``repro.data.synthetic``."""
