from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.train.steps import make_train_step, make_eval_step  # noqa: F401
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: F401
from repro_torch.data.loader import ShardedLoader  # noqa: F401
