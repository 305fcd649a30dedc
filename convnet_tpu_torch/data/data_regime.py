"""DataRegime: the regime-driven input pipeline factory (counterpart of
convnet_tpu/data/data_regime.py).

Settings (dataset, split, batch size, input size, duplicates, augmentation
switches) resolve through the same ``Regime`` engine the optimizer uses;
``set_epoch`` re-resolves and, when a structural setting changed (batch
size, input size, duplicates, ...), rebuilds the loader: that is how
progressive resizing (Mix & Match) and batch-size schedules work. Datasets
are cached by their config key. Models may author ``model.data_regime`` /
``model.data_eval_regime``. ``device`` is where the loaders put batches
(``None``: the card).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from convnet_tpu_torch.data.datasets import get_dataset
from convnet_tpu_torch.data.loader import ArrayBatcher, DataLoader
from convnet_tpu_torch.data.preprocess import _identity_host, get_transform
from convnet_tpu_torch.regimes.regime import Regime

log = logging.getLogger(__name__)

_LOADER_KEYS = ("name", "split", "batch_size", "input_size", "scale_size",
                "augment", "duplicates", "cutout", "autoaugment", "shuffle",
                "drop_last", "num_workers", "data_dir", "lighting",
                "multicrop")


class DataRegime:
    _dataset_cache: Dict[Any, Any] = {}

    def __init__(self, regime=None, defaults: Optional[Dict[str, Any]] = None,
                 process_index: int = 0, process_count: int = 1, seed: int = 0,
                 device=None):
        defaults = dict(defaults or {})
        defaults.setdefault("split", "train")
        defaults.setdefault("augment", defaults["split"] == "train")
        defaults.setdefault("shuffle", defaults["split"] == "train")
        defaults.setdefault("drop_last", defaults["split"] == "train")
        defaults.setdefault("batch_size", 128)
        defaults.setdefault("duplicates", 1)
        defaults.setdefault("num_workers", 8)
        self.regime = Regime(regime, defaults)
        self.epoch = 0
        self.steps = 0
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.device = device
        self._loader = None
        self._loader_key = None
        self.regime.update(0, 0)

    def set_epoch(self, epoch: int, train_steps: int = 0):
        self.epoch = epoch
        self.steps = train_steps
        changed = self.regime.update(epoch, train_steps)
        if changed and self._settings_key() != self._loader_key:
            log.info("data regime changed at epoch %s: %s", epoch,
                     {k: self.regime.setting.get(k) for k in _LOADER_KEYS
                      if k in self.regime.setting})
            self._loader = None
        if self._loader is not None:
            self._loader.set_epoch(epoch)

    def get(self, key, default=None):
        return self.regime.get(key, default)

    def _settings_key(self):
        s = self.regime.resolved()
        return tuple((k, repr(s.get(k))) for k in _LOADER_KEYS)

    def get_loader(self, force_reload: bool = False):
        if self._loader is not None and not force_reload:
            return self._loader
        s = self.regime.resolved()
        name = s["name"]
        dataset_key = (name, s["split"], s.get("data_dir"),
                       repr(s.get("dataset_kwargs")))
        if dataset_key not in self._dataset_cache:
            self._dataset_cache[dataset_key] = get_dataset(
                name, s["split"], s.get("data_dir"),
                **(s.get("dataset_kwargs") or {}))
        dataset = self._dataset_cache[dataset_key]

        transform_name = s.get("transform_name") or (
            "imagenet" if "imagenet" in name
            else name if name in ("cifar10", "cifar100", "mnist", "svhn", "stl10")
            else "imagenet")
        if name.startswith("synthetic") and "imagenet" not in name:
            transform_name = "cifar10" if dataset.data.shape[-1] == 3 else "mnist"
        transform = get_transform(
            transform_name,
            input_size=s.get("input_size"),
            scale_size=s.get("scale_size"),
            augment=s["augment"],
            cutout=s.get("cutout"),
            autoaugment=bool(s.get("autoaugment")),
            duplicates=s["duplicates"],
            lighting=bool(s.get("lighting")),
            multicrop=bool(s.get("multicrop")),
        )

        common = dict(batch_size=s["batch_size"], shuffle=s["shuffle"],
                      drop_last=s["drop_last"], seed=self.seed,
                      process_index=self.process_index,
                      process_count=self.process_count, device=self.device)
        if hasattr(dataset, "data") and transform.host is _identity_host:
            self._loader = ArrayBatcher(dataset, transform, **common)
        else:
            self._loader = DataLoader(dataset, transform,
                                      num_workers=s["num_workers"], **common)
        self._loader.set_epoch(self.epoch)
        self._loader_key = self._settings_key()
        return self._loader

    def __len__(self):
        return len(self.get_loader())
