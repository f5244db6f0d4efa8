"""repro_torch.serving — the continuous-batching LM engine
(``engine.ServeEngine``)."""
