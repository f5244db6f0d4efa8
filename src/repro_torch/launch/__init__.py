"""repro_torch.launch — command-line entry points of the port
(``serve``: the LM engine and the tiny-model serving stack; ``train``: LM
training with checkpoints and elastic restart)."""
