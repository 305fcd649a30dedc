"""The input pipeline: datasets, host and device transforms, the loaders and
the regime-driven ``DataRegime`` (counterpart of convnet_tpu/data)."""

from convnet_tpu_torch.data.preprocess import get_transform, DATASET_STATS
from convnet_tpu_torch.data.datasets import get_dataset
from convnet_tpu_torch.data.loader import DataLoader, ArrayBatcher
from convnet_tpu_torch.data.data_regime import DataRegime
