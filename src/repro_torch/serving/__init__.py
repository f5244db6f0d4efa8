"""repro_torch.serving — the continuous-batching LM engine
(``engine.ServeEngine``) and the multi-tenant tiny-model server
(``engine.TinyModelServer``, a shim over ``repro_torch.serve.Router``)."""
