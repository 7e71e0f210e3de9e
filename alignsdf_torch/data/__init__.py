"""Data: the train dataset over its storage backend, the loader, and
synthetic batches and datasets.

``make_train_dataset`` is the entry the train CLI uses (the JAX package's
``data/__init__.py``; reference utils/data.py:118-129, train.py:425-444).
"""

from __future__ import annotations

from typing import List, Optional


def make_train_dataset(specs, data_root: str, split_keys: Optional[List[str]] = None,
                       raw_image: bool = False):
    """The train dataset over the spec's backend at ``data_root``;
    ``split_keys`` defaults to every key the backend knows."""
    from alignsdf_torch.data.backends import make_backend
    from alignsdf_torch.data.dataset import SDFDataset

    backend = make_backend(specs, data_root)
    keys = split_keys if split_keys is not None else backend.keys()
    if keys is None:
        raise ValueError("split_keys required: the backend lists no keys")
    return SDFDataset(specs, keys, backend, raw_image=raw_image)
