from repro_torch.data.loader import ShardedLoader  # noqa: F401
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: F401
