"""CLI plumbing: arguments, model loading and the datasets (synthetic,
nuScenes, KITTI, Waymo); the parts of supnerf_tpu/cli/common.py the
optimize and train entry points need, with the JAX CLIs' device and
profiler flags (add_device_args, device_from_args, maybe_profile)."""
from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from supnerf_tpu_torch.data.synthetic import make_synthetic_object
from supnerf_tpu_torch.device import resolve_device
from supnerf_tpu_torch.models.factory import build_model, init_model


def str2bool(v) -> bool:
    """argparse type for yes/no flags (the JAX CLI's str2bool)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def add_device_args(p: argparse.ArgumentParser):
    """--device, --profile_dir, and the JAX CLIs' --devices, --gpu and
    --coordinator (JAX cli/common.py add_common_args), which are accepted so
    that a reference command line runs and select nothing: the port runs on
    one card, and device_from_args refuses more (ROADMAP.md §A.13)."""
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the run to DIR/trace.json")
    for flag in ("--devices", "--gpu"):
        p.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", type=str, default=None, help=argparse.SUPPRESS)
    return p


def device_from_args(args) -> torch.device:
    """The entry point's device (device.resolve_device(--device)). --devices
    other than 1 and a coordinator (--coordinator or JAX_COORDINATOR_ADDRESS)
    raise ValueError before any work, rather than run on fewer devices."""
    coordinator = args.coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if args.devices not in (None, 1) or coordinator:
        raise ValueError(f"--devices {args.devices}, coordinator {coordinator!r}: the port runs "
                         "on one card; data parallelism over several cards or hosts is not "
                         "ported (ROADMAP.md §A.13, multi-GPU)")
    return resolve_device(args.device)


def maybe_profile(args):
    """utils.profiling.trace(--profile_dir) when the flag is given, else a
    context that does nothing (JAX cli/common.py maybe_profile)."""
    if args.profile_dir:
        from supnerf_tpu_torch.utils.profiling import trace

        return trace(args.profile_dir)
    return contextlib.nullcontext()


def add_optimize_args(p: argparse.ArgumentParser):
    p.add_argument("--config_file", type=str, default="supnerf.nusc.vehicle.car.json")
    p.add_argument("--seed", type=int, default=0)
    add_device_args(p)
    p.add_argument("--model_epoch", type=int, default=None)
    p.add_argument("--init_rot_err", type=float, default=None,
                   help="initial rotation error in radians (add_pose_err 1); default 0.0 "
                        "(nuScenes) / 0.4 (cli.optimize_kitti, cli.optimize_waymo)")
    p.add_argument("--init_trans_err", type=float, default=None,
                   help="initial translation error ratio (add_pose_err 1); default 0.2 "
                        "(nuScenes) / 0.01 (cli.optimize_kitti, cli.optimize_waymo)")
    p.add_argument("--rand_angle_lim", type=float, default=0.0)
    p.add_argument("--seg_source", type=str, default="instance")
    p.add_argument("--num_workers", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--nusc-version", dest="nusc_version", type=str, default=None)
    p.add_argument("--add_pose_err", type=int, default=2, choices=[0, 1, 2, 3])
    p.add_argument("--reg_iters", type=int, default=3)
    p.add_argument("--opt_pose", type=int, default=1, choices=[0, 1, 2],
                   help="0: the codes alone; 1: codes and pose; 2: codes and pose, the "
                        "initial pose from PnP on the encoder's corner prediction")
    p.add_argument("--pred_wlh", type=int, default=0, choices=[0, 1, 2],
                   help="0: the annotated box size; 1: the encoder's; 2: the encoder's "
                        "volume at the nuScenes mean width and height")
    p.add_argument("--opt_multiview", type=str2bool, default=False,
                   help="optimize each instance's views jointly (shared codes)")
    p.add_argument("--code_level", type=int, default=None, choices=[0, 1, 2],
                   help="codes stored per instance (0), annotation (1) or (annotation, "
                        "camera) (2, the default; --opt_multiview forces 0)")
    p.add_argument("--cross_eval_folder", type=str, default=None,
                   help="evaluate only: the cross-view evaluation and the report of this "
                        "folder's codes+poses.pkl")
    p.add_argument("--pred_box2d", type=int, default=0)
    p.add_argument("--vis", type=int, default=0, choices=[0, 1, 2],
                   help="panels per object under the results folder: 1 the first and last "
                        "snapshot, 2 every iteration; both also the 8 virtual views and the "
                        "final render's SSIM")
    p.add_argument("--num_subset", type=int, default=1,
                   help="legacy manual sharding: total subsets")
    p.add_argument("--id_subset", type=int, default=0,
                   help="legacy manual sharding: this process's subset id")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--save_postfix", type=str, default="")
    p.add_argument("--save_dir", type=str, default=None,
                   help="results folder (default: under the config's model_dir)")
    p.add_argument("--save_freq", type=int, default=100)
    p.add_argument("--dataset", type=str, default=None,
                   help="nusc | kitti | waymo | synthetic (default: the config's)")
    p.add_argument("--num-samples2eval", dest="num_samples2eval", type=int, default=None,
                   help="evaluate only the first N objects (reference optimize_kitti.py:44)")
    p.add_argument("--num_objects", type=int, default=32, help="synthetic dataset size")
    return p


def mean_codes(shape_codes, texture_codes, optimized_idx) -> tuple:
    """Mean shape / texture codes (numpy) over the instances that were
    trained (reference load_model :1799-1808), over all of them when none
    was; tensors or arrays of one state or checkpoint."""
    sc, tc, opt = (torch.as_tensor(t).detach().cpu().numpy()
                   for t in (shape_codes, texture_codes, optimized_idx))
    if (opt > 0).any():
        sc, tc = sc[opt > 0], tc[opt > 0]
    return sc.mean(0), tc.mean(0)


def load_model_and_codes(hpams: dict, device, model_epoch=None, seed: int = 0):
    """Build the model of hpams["arch"] (any arch of models/factory.py) and
    load a reference-format checkpoint (model_dir/models.pth or epoch_N.pth:
    {'model_params', 'shape_code_params', 'texture_code_params', ...},
    reference trainer_unified_nuscenes.py:476-490; CodeNeRF's model_params
    hold the decoder alone) strictly; without one, fresh weights from `seed`
    and zero mean codes."""
    model = build_model(hpams["arch"], hpams["net_hyperparams"])
    latent = hpams["net_hyperparams"].get("latent_dim", 256)
    model_dir = hpams.get("model_dir", "")
    names = ([f"epoch_{model_epoch}.pth"] if model_epoch is not None else []) + ["models.pth"]
    path = next((os.path.join(model_dir, n) for n in names
                 if model_dir and os.path.exists(os.path.join(model_dir, n))), None)
    if path is None and model_dir and os.path.exists(os.path.join(model_dir, "latest.json")):
        raise ValueError(f"{model_dir} holds a JAX-package checkpoint; convert its variables "
                         "with supnerf_tpu_torch.models.convert first")
    if path is not None:
        saved = torch.load(path, map_location="cpu", weights_only=False)
        model.load_state_dict(saved["model_params"], strict=True)
        shape_w = saved["shape_code_params"]["weight"]
        mean_shape, mean_texture = mean_codes(
            shape_w, saved["texture_code_params"]["weight"],
            saved.get("optimized_idx", torch.zeros(len(shape_w))))
        print(f"loaded reference checkpoint {path}")
    else:
        init_model(model, seed)
        mean_shape = mean_texture = np.zeros(latent, np.float32)
    return model.to(device), mean_shape, mean_texture


class SyntheticDataset:
    """n synthetic objects, two views per instance (the JAX CLI's synthetic set)."""

    def __init__(self, n: int):
        self.samples = []
        for i in range(n):
            s = make_synthetic_object(seed=1000 + i)
            s.update(instoken=f"ins_{i // 2}", anntoken=f"ann_{i}", cam_ids="CAM_FRONT")
            self.samples.append(s)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class _Subset:
    """The items idx of a dataset (legacy sharding, --num-samples2eval)."""

    def __init__(self, base, idx):
        self.base, self.idx = base, list(idx)

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.base[self.idx[i]]


def dataset_name(hpams: dict, args) -> str:
    return args.dataset or hpams.get("dataset", {}).get("name", "synthetic")


def build_dataset(hpams: dict, args, split: str = "val"):
    """The dataset named by --dataset or the config (JAX cli/common.py
    build_dataset): its reader, then the strided --num_subset / --id_subset
    shard and, outside training, the first --num-samples2eval objects."""
    name = dataset_name(hpams, args)
    if name == "synthetic":
        ds = SyntheticDataset(getattr(args, "num_objects", 32))
    elif name == "nusc":
        from supnerf_tpu_torch.data.nuscenes import NuScenesData

        dir_key = "train_data_dir" if split == "train" else "test_data_dir"
        data_dir = hpams["dataset"].get(dir_key, "data/NuScenes")
        ds = NuScenesData(hpams, split=split, add_pose_err=getattr(args, "add_pose_err", 0),
                          pred_box2d=bool(getattr(args, "pred_box2d", 0)),
                          nusc_version=getattr(args, "nusc_version", None),
                          rand_angle_lim=getattr(args, "rand_angle_lim", 0.0),
                          seg_dir=os.path.join(data_dir,
                                               f"pred_{getattr(args, 'seg_source', 'instance')}"))
    elif name in ("kitti", "waymo"):
        from supnerf_tpu_torch.data.kitti import KittiData
        from supnerf_tpu_torch.data.waymo import WaymoData

        ds = (KittiData if name == "kitti" else WaymoData)(
            hpams, split=split, add_pose_err=getattr(args, "add_pose_err", 0))
    else:
        raise ValueError(f"Unknown dataset: {name}")
    num_subset = getattr(args, "num_subset", 1)
    if num_subset > 1:
        ds = _Subset(ds, range(getattr(args, "id_subset", 0), len(ds), num_subset))
    n_eval = getattr(args, "num_samples2eval", None)
    if n_eval is not None and split != "train":
        ds = _Subset(ds, range(min(n_eval, len(ds))))
    return ds
