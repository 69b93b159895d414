"""Training CLI (port of ``tpupose/apps/train_cli.py``, the reference's
``train_coco_pose_estimation.py``).

The same flags and schedule, on one CUDA device by default: an eager train
step (``tpupose_torch.train``), the process-pool loader, ``torch.save``
snapshots and Chainer-npz exports, JSON LogReport-parity logging.

Usage:
  python -m tpupose_torch.apps.train_cli --coco_dir /data/coco \\
      --out result/run1 --batchsize 10 --iteration 300000 --loaderjob 4
  python -m tpupose_torch.apps.train_cli --synthetic --test [--bf16]
  python -m tpupose_torch.apps.train_cli --synthetic --test \\
      --device cpu --insize 64          # a small run on the CPU

Without CUDA it raises unless given ``--device cpu``.

On several cards, one process per card under ``torchrun`` (NCCL on CUDA,
gloo on the CPU), the batch split over ``--n_data`` ranks and the image
rows over ``--n_spatial`` (``tpupose_torch/parallel``):
  torchrun --nproc_per_node 4 -m tpupose_torch.apps.train_cli \
      --synthetic --test --n_data 4
Only rank 0 writes the log, the snapshots and the npz exports; every rank
loads a ``--resume`` snapshot.  A caller that has already initialised
``torch.distributed`` (one process per rank, ``main(argv)`` in each) runs
on its process group.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train pose estimation (CUDA)")
    p.add_argument("--arch", "-a", default="posenet",
                   choices=("posenet", "facenet", "handnet"))
    p.add_argument("--batchsize", "-B", type=int, default=10)
    p.add_argument("--valbatchsize", "-b", type=int, default=4)
    p.add_argument("--val_samples", type=int, default=100)
    p.add_argument("--iteration", "-i", type=int, default=300000)
    p.add_argument("--initmodel", help="warm-start weights (.npz)")
    p.add_argument("--vgg", help="warm-start the VGG-19 stem from a Caffe "
                   "VGG release (.caffemodel; copy_vgg_params parity)")
    p.add_argument("--loaderjob", "-j", type=int, default=0,
                   help="number of data-loading worker processes")
    p.add_argument("--resume", "-r", default="",
                   help="resume from checkpoint dir (or 'auto')")
    p.add_argument("--out", "-o", default="result/test")
    p.add_argument("--coco_dir", default="coco",
                   help="COCO root (annotations/, train2017/, ...)")
    p.add_argument("--test", action="store_true",
                   help="10 iterations, small val, for smoke testing")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated labeled crops instead of COCO "
                        "(REQUIRED for facenet/handnet: no face/hand "
                        "keypoint dataset exists)")
    p.add_argument("--n_data", type=int, default=None,
                   help="data-parallel ranks (default: the largest count "
                        "of the world's that divides both batch sizes)")
    p.add_argument("--n_spatial", type=int, default=1,
                   help="ranks splitting each image's rows")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (f32 params/loss)")
    p.add_argument("--insize", type=int, default=368,
                   help="training input size (368 = reference)")
    p.add_argument("--log_interval", type=int, default=None,
                   help="iterations per log entry (default: config; "
                        "metrics stay on device between entries)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only for small test runs)")
    return p.parse_args(argv)


def _mesh(args, device):
    """The (data, spatial) mesh of this process group (initialised from
    ``torchrun``'s variables when they are set and it is not yet), or None
    for one process."""
    import torch.distributed as dist

    from tpupose_torch.parallel import initialize_distributed, make_mesh

    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        initialize_distributed(device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_data = args.n_data
    if n_data is None:
        # the largest data-parallel degree dividing BOTH batch sizes (the
        # validation loop splits its batches over the same mesh)
        n_data = max(d for d in range(1, max(world // args.n_spatial, 1)
                                      + 1)
                     if args.batchsize % d == 0
                     and args.valbatchsize % d == 0)
    try:
        mesh = make_mesh(n_data, args.n_spatial, device=device)
    except ValueError as e:
        raise SystemExit(f"--n_data {n_data} --n_spatial {args.n_spatial}: "
                         f"{e} (launch one process per rank with torchrun)")
    return mesh if world > 1 else None


def main(argv=None):
    import torch

    from tpupose_torch.config import TrainConfig
    from tpupose_torch.data import BatchLoader, CocoPoseDataset
    from tpupose_torch.detectors.net import float32_numerics
    from tpupose_torch.models import ARCHS
    from tpupose_torch.train import (init_train_state, make_eval_step,
                                     make_train_step)
    from tpupose_torch.train.checkpoint import (export_model_npz,
                                                latest_checkpoint,
                                                restore_checkpoint,
                                                save_checkpoint)
    from tpupose_torch.train.trainer import training_device
    from tpupose_torch.utils.reporting import (ProgressBar, TrainLogger,
                                               dump_computation_graph,
                                               dump_run_params)
    from tpupose_torch.weights import load_chainer_npz, warn_on_load_report

    args = parse_args(argv)
    if args.arch != "posenet" and not args.synthetic:
        raise SystemExit(
            f"--arch {args.arch} cannot train on COCO: the dataset has no "
            "face/hand keypoint labels (the reference trainer's loss is "
            "pose-only too).  Pass --synthetic for a smoke run on "
            "generated labeled crops, or feed a labeled-crop dataset "
            "through tpupose_torch.train.make_train_step directly.")
    device = training_device(args.device)
    mesh = _mesh(args, device)
    if mesh is not None:
        device = mesh.device
    writer = mesh is None or mesh.rank == 0
    cfg = TrainConfig(batch_size=args.batchsize, iterations=args.iteration,
                      insize=args.insize)
    iterations = min(args.iteration, 10) if args.test else args.iteration
    val_interval = 10 if args.test else cfg.snapshot_interval
    log_interval = (args.log_interval if args.log_interval
                    else (1 if args.test else cfg.log_interval))

    model = ARCHS[args.arch](
        dtype=torch.bfloat16 if args.bf16 else torch.float32)
    if args.initmodel:
        print("Load model from", args.initmodel)
        report = load_chainer_npz(model, args.initmodel)
        warn_on_load_report(report, args.initmodel, arch=args.arch)
    elif args.vgg and args.arch == "posenet":
        from tpupose_torch.weights.caffe import init_stem_from_caffe_vgg

        print("Warm-starting VGG stem from", args.vgg)
        init_stem_from_caffe_vgg(model, args.vgg)
    state = init_train_state(model, cfg, arch=args.arch, device=device,
                             mesh=mesh)
    step = make_train_step(cfg, mesh=mesh)
    eval_step = make_eval_step(cfg, mesh=mesh)
    if writer:
        print(f"device: {device}"
              + (f" ({torch.cuda.get_device_name(device)})"
                 if device.type == "cuda" else ""))
        if mesh is not None:
            print(f"mesh: data={mesh.n_data} spatial={mesh.n_spatial}")

    if args.resume:
        path = (latest_checkpoint(args.out) if args.resume == "auto"
                else args.resume)
        if path:
            print("Resume from", path)
            state = restore_checkpoint(path, state)

    if args.synthetic:
        from tpupose_torch.data import SyntheticCropDataset

        num_keypoints = {"posenet": 18, "facenet": 70, "handnet": 21}
        k = num_keypoints[args.arch]
        train_ds = SyntheticCropDataset(
            k, insize=cfg.insize,
            n_samples=max(64, 4 * args.batchsize), seed=0)
        val_ds = SyntheticCropDataset(
            k, insize=cfg.insize,
            n_samples=(8 if args.test else args.val_samples), seed=1)
        max_persons = 1  # one synthetic person per crop
    else:
        ann = os.path.join(args.coco_dir, "annotations")
        train_ds = CocoPoseDataset(
            os.path.join(ann, "person_keypoints_train2017.json"),
            os.path.join(args.coco_dir, "train2017"),
            mask_dir=os.path.join(args.coco_dir, "ignore_mask_train2017"),
            mode="train", cfg=cfg)
        val_ds = CocoPoseDataset(
            os.path.join(ann, "person_keypoints_val2017.json"),
            os.path.join(args.coco_dir, "val2017"),
            mask_dir=os.path.join(args.coco_dir, "ignore_mask_val2017"),
            mode="val", cfg=cfg,
            n_samples=(8 if args.test else args.val_samples))
        max_persons = cfg.max_persons
    pin = device.type == "cuda"
    train_loader = BatchLoader(
        train_ds, args.batchsize, max_persons=max_persons,
        num_workers=args.loaderjob, pin_memory=pin, mesh=mesh)

    logger = None
    if writer:
        logger = TrainLogger(args.out, log_interval=log_interval)
        dump_run_params(args.out, vars(args))

    def run_validation(model):
        val_loader = BatchLoader(
            val_ds, args.valbatchsize, max_persons=max_persons,
            shuffle=False, repeat=False, pin_memory=pin, mesh=mesh)
        sums, n = {}, 0
        for batch in val_loader:
            m = eval_step(model, batch)
            for k in ("loss", "paf", "heat"):
                sums[k] = sums.get(k, 0.0) + float(m[k])
            n += 1
        return {f"val/{k}": v / max(n, 1) for k, v in sums.items()}

    it = iter(train_loader)
    epoch_len = max(len(train_ds) // args.batchsize, 1)
    start = state.step
    # Per-step metrics stay on the device between log points: a float()
    # per iteration would wait for the device every step.  One stacked
    # copy per log window keeps LogReport's window averages exactly.
    metric_keys = ("loss", "paf", "heat")
    pending = []  # [(iteration, {k: device scalar})]

    def flush_metrics(extra_scalars=None, last_iter=None):
        if not writer:
            pending.clear()
        if not pending:
            return
        stacked = torch.stack([torch.stack([m[k] for k in metric_keys])
                               for _, m in pending]).cpu().numpy()
        for (it_n, _), row in zip(pending, stacked):
            scalars = {f"main/{k}": float(v)
                       for k, v in zip(metric_keys, row)}
            if extra_scalars and it_n == last_iter:
                scalars.update(extra_scalars)
            logger.observe(it_n, scalars, epoch=it_n // epoch_len)
        pending.clear()

    progress = (None if args.test or not writer
                else ProgressBar(iterations, update_interval=log_interval))
    # float32 convs without TF32 and deterministic cuDNN algorithms, as
    # the detectors run them; bf16 convs are bf16 either way
    with float32_numerics():
        for i in range(start, iterations):
            batch = next(it)
            if i == start and writer:
                dump_computation_graph(args.out, state.model, cfg, batch)
            state, metrics = step(state, batch)
            pending.append((i + 1, metrics))
            if progress:
                progress.update(i + 1)
            if (i + 1) % val_interval == 0:
                extra = run_validation(state.model)
                if writer:
                    save_checkpoint(args.out, state)
                    export_model_npz(args.out, state)
                flush_metrics(extra, last_iter=i + 1)
            elif (i + 1) % log_interval == 0 or i + 1 == iterations:
                flush_metrics()

    if writer:
        save_checkpoint(args.out, state)
        export_model_npz(args.out, state, name=f"{args.arch}_final.npz")
    train_loader.close()
    if writer:
        print("done:", state.step, "iterations")


if __name__ == "__main__":
    main()
