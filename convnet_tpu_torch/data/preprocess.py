"""Dataset statistics and eval geometry, copied from
convnet_tpu/data/preprocess.py (DATASET_STATS, default_image_size) so the
port never imports the JAX package. A CPU test holds the two copies equal.
"""

from __future__ import annotations

DATASET_STATS = {
    "imagenet": {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]},
    "cifar10": {"mean": [0.491, 0.482, 0.447], "std": [0.247, 0.243, 0.262]},
    "cifar100": {"mean": [0.507, 0.487, 0.441], "std": [0.267, 0.256, 0.276]},
    "mnist": {"mean": [0.1307], "std": [0.3081]},
    "stl10": {"mean": [0.447, 0.440, 0.407], "std": [0.260, 0.257, 0.271]},
    "svhn": {"mean": [0.438, 0.444, 0.473], "std": [0.198, 0.201, 0.197]},
}


def default_image_size(dataset: str) -> int:
    """The eval-geometry default per dataset."""
    name = str(dataset).lower()
    if name in ("cifar10", "cifar100", "svhn", "stl10", "mnist"):
        return {"stl10": 96, "mnist": 28}.get(name, 32)
    return 224
