"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``).

Parity: python/mxnet/gluon/data/vision/datasets.py (MNIST, FashionMNIST,
CIFAR10/100, ImageFolderDataset/ImageRecordDataset).  They read local
files only (nothing is downloaded); when the files are absent they fall
back to the reference's deterministic synthetic sample set of the right
shapes, flagged by ``synthetic=True``.  Items are host NDArrays.
"""
from __future__ import annotations

import gzip
import os
import struct
import numpy as onp

from ...data.dataset import Dataset, RecordFileDataset
from ....io.io import host_nd

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageListDataset",
           "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self.synthetic = False
        self._get_data()

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        data = host_nd(self._data[idx])
        label = int(self._label[idx])
        if self._transform is not None:
            return self._transform(data, label)
        return data, label

    def _get_data(self):
        raise NotImplementedError


def _synthetic(n, shape, num_classes, seed):
    rng = onp.random.RandomState(seed)
    # class-dependent means so simple models can actually fit the data
    labels = rng.randint(0, num_classes, size=n).astype(onp.int32)
    base = rng.uniform(0, 64, size=(num_classes,) + shape).astype(onp.float32)
    data = base[labels] + rng.uniform(0, 32, size=(n,) + shape)
    return data.astype(onp.uint8), labels


class MNIST(_DownloadedDataset):
    """Parity: datasets.py MNIST; reads idx-ubyte files when present."""

    _shape = (28, 28, 1)
    _classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        prefix = "train" if self._train else "t10k"
        img_path = os.path.join(self._root, f"{prefix}-images-idx3-ubyte.gz")
        lbl_path = os.path.join(self._root, f"{prefix}-labels-idx1-ubyte.gz")
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            with gzip.open(lbl_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                self._label = onp.frombuffer(f.read(), dtype=onp.uint8) \
                    .astype(onp.int32)
            with gzip.open(img_path, "rb") as f:
                _, num, rows, cols = struct.unpack(">IIII", f.read(16))
                data = onp.frombuffer(f.read(), dtype=onp.uint8)
                self._data = data.reshape(num, rows, cols, 1)
        else:
            n = 2048 if self._train else 512
            self._data, self._label = _synthetic(n, self._shape,
                                                 self._classes,
                                                 42 if self._train else 7)
            self.synthetic = True


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    _shape = (32, 32, 3)
    _classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        batches = [f"data_batch_{i}" for i in range(1, 6)] if self._train \
            else ["test_batch"]
        dirp = os.path.join(self._root, "cifar-10-batches-py")
        if os.path.isdir(dirp):
            import pickle
            data, labels = [], []
            for b in batches:
                with open(os.path.join(dirp, b), "rb") as f:
                    d = pickle.load(f, encoding="latin1")
                data.append(d["data"].reshape(-1, 3, 32, 32)
                            .transpose(0, 2, 3, 1))
                labels.extend(d["labels"])
            self._data = onp.concatenate(data)
            self._label = onp.asarray(labels, dtype=onp.int32)
        else:
            n = 2048 if self._train else 512
            self._data, self._label = _synthetic(n, self._shape,
                                                 self._classes,
                                                 43 if self._train else 8)
            self.synthetic = True


class CIFAR100(CIFAR10):
    _classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        n = 2048 if self._train else 512
        self._data, self._label = _synthetic(
            n, self._shape, self._classes if self._fine else 20,
            44 if self._train else 9)
        self.synthetic = True


class ImageFolderDataset(Dataset):
    """Parity: datasets.py ImageFolderDataset — label = subfolder index."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        self._list_images(self._root)

    def _list_images(self, root):
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if filename.lower().endswith(
                        (".jpg", ".jpeg", ".png", ".bmp", ".npy")):
                    self.items.append((os.path.join(path, filename), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = onp.load(path)
        else:
            from ....image import imread
            img = imread(path, self._flag).asnumpy()
        data = host_nd(img)
        if self._transform is not None:
            return self._transform(data, label)
        return data, label


class ImageRecordDataset(RecordFileDataset):
    """Dataset over a .rec of packed images (parity: datasets.py
    ImageRecordDataset): item = (image NDArray, label)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....image.image import imdecode
        from ....recordio import unpack
        record = super().__getitem__(idx)
        header, payload = unpack(record)
        label = header.label
        # imdecode handles the BGR->RGB flip (reference parity:
        # ImageRecordDataset returns RGB via image.imdecode)
        img = imdecode(payload, flag=self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageListDataset(Dataset):
    """Dataset over an explicit [(path-or-array, label), ...] list or a
    .lst file (parity: datasets.py ImageListDataset)."""

    def __init__(self, root=".", imglist=None, flag=1):
        self._flag = flag
        self._items = []
        if isinstance(imglist, str):
            with open(imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        continue
                    label = [float(x) for x in parts[1:-1]]
                    label = label[0] if len(label) == 1 else onp.asarray(
                        label, onp.float32)
                    self._items.append(
                        (os.path.join(root, parts[-1]), label))
        else:
            # reference convention: each entry is [label, path-or-image]
            for entry in (imglist or []):
                label, src = entry[0], entry[1]
                if isinstance(src, str):
                    src = os.path.join(root, src)
                self._items.append((src, label))

    def __len__(self):
        return len(self._items)

    def __getitem__(self, idx):
        from ....image.image import imread
        src, label = self._items[idx]
        img = imread(src, self._flag) if isinstance(src, str) \
            else host_nd(onp.asarray(src))
        return img, label
