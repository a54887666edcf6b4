"""DeepGalaxy dataset: HDF5 galaxy-merger image sets conditioned on
(mass ratio m, size ratio s, time t, camera position c).

Port of ``rho_diffusion_tpu/data/deep_galaxy.py`` (reference
deep_galaxy.py:38-317), numpy-native and channels-LAST:

* class-level parameter space s/m in {0.25..1.5}, t in 300..650 step 5,
  c in 0..13;
* regex dataset-name selection, camera-position list (or "*", or a quoted
  "3,7"), t-range filter and ``t_exclude``;
* per-stack normalisation by the stack's max;
* labels = float rows of raw (s, m, t, c), or sha512 hash embeddings
  (length 128) when ``use_emb_as_labels=True``, with the reference's s/m
  swap in the hashed dict;
* ``loaded_parameter_space`` rebuilt from the unique values present;
* transform: center-crop 256 -> 2x2 average-pool to 128 -> [-1, 1].

h5py is imported only when a file is read.
"""
from __future__ import annotations

import re
from typing import Callable, Optional, Sequence

import numpy as np

from rho_diffusion_tpu_torch.data.base import MultiVariateDataset
from rho_diffusion_tpu_torch.data.parameter_space import DiscreteParameterSpace
from rho_diffusion_tpu_torch.registry import registry
from rho_diffusion_tpu_torch.utils import calculate_sha512_embedding


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Center-crop the leading two (H, W) axes to ``size``; pads if small."""
    h, w = img.shape[:2]
    if h < size or w < size:
        ph, pw = max(size - h, 0), max(size - w, 0)
        img = np.pad(
            img,
            ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2))
            + ((0, 0),) * (img.ndim - 2),
        )
        h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top : top + size, left : left + size]


def downscale_2x(img: np.ndarray, factor: int) -> np.ndarray:
    """Integer-factor average-pool downscale of the leading two axes."""
    if factor == 1:
        return img
    h, w = img.shape[:2]
    img = img[: h - h % factor, : w - w % factor]
    new_h, new_w = img.shape[0] // factor, img.shape[1] // factor
    return img.reshape(new_h, factor, new_w, factor, *img.shape[2:]).mean(axis=(1, 3))


def default_transform(img: np.ndarray) -> np.ndarray:
    """CenterCrop(256) -> Resize(128) -> scale [0,1] -> [-1,1]
    (reference deep_galaxy.py:84-94). Channels-last output [128, 128, 1]."""
    img = center_crop(img, 256)
    img = downscale_2x(img, 2)
    img = img.astype(np.float32) * 2.0 - 1.0
    if img.ndim == 2:
        img = img[..., None]
    return img


@registry.register_dataset("DeepGalaxyDataset")
class DeepGalaxyDataset(MultiVariateDataset):
    parameter_space = DiscreteParameterSpace(
        param_dict={
            "s": [0.25, 0.5, 0.75, 1, 1.25, 1.5],
            "m": [0.25, 0.5, 0.75, 1, 1.25, 1.5],
            "t": list(range(300, 655, 5)),
            "c": list(range(14)),
        },
    )

    def __init__(
        self,
        path: str,
        use_emb_as_labels: bool = True,
        dset_name_pattern: str = "s_*",
        camera_pos: Sequence[int] | int | str = (0,),
        t_lim: Optional[Sequence[int]] = None,
        t_exclude: Optional[Sequence[float]] = None,
        transform: Optional[Callable] = None,
        target_transform: Optional[Callable] = None,
    ) -> None:
        self.h5fn = path
        self.use_emb_as_labels = use_emb_as_labels
        self.dset_name_pattern = dset_name_pattern
        self.camera_pos = camera_pos
        self.t_lim = t_lim
        self.t_exclude = t_exclude
        self.transform = transform or default_transform
        self.target_transform = target_transform
        self.attributes = ["s", "m", "t", "c"]
        self.loaded_parameter_space = DiscreteParameterSpace(
            param_dict={"s": [], "m": [], "t": [], "c": []},
        )
        self.num_classes = 0
        self.data: Optional[np.ndarray] = None
        self.labels: Optional[np.ndarray] = None
        self._load_all(dset_name_pattern, camera_pos, t_lim, t_exclude)

    def __len__(self) -> int:
        return 0 if self.data is None else self.data.shape[0]

    def __getitem__(self, idx: int):
        image = self.data[idx]
        label = self.labels[idx]
        if self.transform:
            image = self.transform(image)
        if self.use_emb_as_labels:
            label = calculate_sha512_embedding(
                # reference key order: m<-s, s<-m swap preserved from its
                # calculate_embeddings (deep_galaxy.py:146-151)
                {"m": int(label[1]), "s": int(label[0]), "t": int(label[2]),
                 "c": int(label[3])},
                l=128,
            )
        elif self.target_transform:
            label = self.target_transform(label)
        return image, np.asarray(label, dtype=np.float32)

    # -- loading (reference :165-281) -------------------------------------
    def _load_all(self, dset_name_pattern, camera_pos, t_lim, t_exclude=None) -> None:
        import h5py

        with h5py.File(self.h5fn, "r") as h5f:
            pattern = re.compile(dset_name_pattern)
            matched = [k for k in h5f.keys() if pattern.match(k)]
            if isinstance(camera_pos, int):
                camera_pos = [camera_pos]
            elif isinstance(camera_pos, str):
                if camera_pos == "*":
                    camera_pos = range(0, 14)
                else:
                    # JSON configs often quote numbers ("3" or "3,7"); a
                    # bare string would otherwise iterate per CHARACTER and
                    # crash on the :02d key format below
                    camera_pos = [int(c) for c in camera_pos.split(",")]

            images_set, s_set, m_set, t_set, c_set = [], [], [], [], []
            for dset_name in matched:
                # s/m ratios encoded in the group name "s_<s>_m_<m>"
                parts = dset_name.split("_")
                s_val, m_val = float(parts[1]), float(parts[3])
                for cpos in camera_pos:
                    images = np.asarray(h5f[f"/{dset_name}/images_camera_{cpos:02d}"])
                    images = images / np.max(images)
                    t_vals = np.asarray(h5f[f"{dset_name}/t_myr_camera_{cpos:02d}"])
                    s_vals = np.full(t_vals.shape, s_val)
                    m_vals = np.full(t_vals.shape, m_val)
                    c_vals = np.full(t_vals.shape, cpos, dtype=np.int32)
                    if t_lim is not None:
                        lo, hi = np.min(t_lim), np.max(t_lim)
                        keep = (t_vals >= lo) & (t_vals <= hi)
                        images, t_vals = images[keep], t_vals[keep]
                        s_vals, m_vals, c_vals = s_vals[keep], m_vals[keep], c_vals[keep]
                    if t_exclude is not None:
                        # condition holdout: drop exact time values after
                        # the per-stack max normalisation above, so the
                        # retained frames are bitwise those of a full load
                        keep = ~np.isin(t_vals, np.asarray(t_exclude))
                        images, t_vals = images[keep], t_vals[keep]
                        s_vals, m_vals, c_vals = s_vals[keep], m_vals[keep], c_vals[keep]
                    images_set.append(images)
                    s_set.append(s_vals)
                    m_set.append(m_vals)
                    t_set.append(t_vals)
                    c_set.append(c_vals)

        if not images_set:
            raise ValueError(
                f"no datasets matched pattern '{dset_name_pattern}' with "
                f"cameras {list(camera_pos)} in {self.h5fn}",
            )
        self.data = np.concatenate(images_set, axis=0)
        s_all = np.concatenate(s_set)
        m_all = np.concatenate(m_set)
        t_all = np.concatenate(t_set)
        c_all = np.concatenate(c_set)
        for key, vals in (("s", s_all), ("m", m_all), ("t", t_all), ("c", c_all)):
            self.loaded_parameter_space[key] = sorted(np.unique(vals).tolist())
        self.num_classes = len(np.unique(t_all))
        # label rows in attribute order (s, m, t, c) — reference :268-270
        self.labels = np.stack([s_all, m_all, t_all, c_all], axis=1).astype(np.float32)
