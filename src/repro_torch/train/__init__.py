from repro_torch.train.loop import (  # noqa: F401
    ElasticRestart,
    LoopConfig,
    LoopResult,
    TornStateError,
    run_training,
)
from repro_torch.train.steps import (  # noqa: F401
    TrainState,
    make_eval_step,
    make_train_step,
)
