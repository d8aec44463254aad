"""ImageNet training example for apex_tpu_torch, the PyTorch / NVIDIA GPU
port: examples/imagenet/main_amp.py (the JAX package's) with the same
command line and the same step: amp.initialize on the model and the
optimizer, then the functional step of main_amp.py:240-262 --
``amp.scaled_grad`` (loss, logits and the scaled grads),
``ddp.allreduce_grads(grads)`` across ranks, ``optimizer.step(grads)``,
loss and Prec@1 averaged over the ranks -- turned by ``make_step`` into
one CUDA graph on the GPU (the JAX example jits it), so a training step
is one graph replay.  Under the port's launcher (WORLD_SIZE > 1) a
torch.distributed group (NCCL on the GPU, gloo on the CPU) and
parallel.DistributedDataParallel.  Synthetic ImageNet-shaped data unless
--data names an .npz.  On the GPU the warm-up takes two steps: the first
runs eagerly (it builds the kernels), the second captures the graph.

Run on the GPU:
  python examples/imagenet/main_amp_torch.py --arch resnet50 -b 128
Run on the CPU (the plain versions of the kernels):
  python examples/imagenet/main_amp_torch.py --device cpu --arch resnet18 \\
      -b 4 --image-size 32 --iters 3
Two ranks:
  python -m apex_tpu_torch.parallel.multiproc --nprocs 2 \\
      examples/imagenet/main_amp_torch.py --device cpu ...

``--zero`` shards the masters and the moments over the ranks (ZeRO-1,
``AmpOptimizer.zero_shard``; main_amp.py:227-250): the step reduces its
own grads (a reduce-scatter), so the data-parallel all-reduce is skipped.
Unlaunched, a group of one rank is made for it.  Its checkpoint holds
what the JAX example's holds, whole arrays: every rank gathers its
optimizer windows and rank 0 writes them through utils/checkpoint.py;
``--resume`` gives each rank its window back, at any world size.

A resume loads the checkpoint after the warm-up steps, in place (the
captured graph keeps its buffers), so the resumed run continues exactly
where the saved one stopped.

``main(argv)`` runs in process and returns the mean img/s.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

# allow running straight from a source checkout
_repo = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if (os.path.isdir(os.path.join(_repo, "apex_tpu_torch"))
        and _repo not in sys.path):
    sys.path.insert(0, _repo)

from apex_tpu_torch import _native, amp, models  # noqa: E402
from apex_tpu_torch import optimizers, parallel  # noqa: E402
from apex_tpu_torch.data import (DataLoader, IMAGENET_MEAN,  # noqa: E402
                                 IMAGENET_STD)
from apex_tpu_torch._device import resolve_device  # noqa: E402
from apex_tpu_torch.nn.functional import cross_entropy  # noqa: E402
from apex_tpu_torch.utils import AverageMeter, profiler  # noqa: E402
from apex_tpu_torch.utils import checkpoint as ckpt  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="apex_tpu_torch ImageNet "
                                            "training")
    p.add_argument("--data", default=None,
                   help="optional .npz with images/labels; synthetic if unset")
    p.add_argument("--arch", "-a", default="resnet50",
                   choices=["resnet18", "resnet34", "resnet50",
                            "resnet101", "resnet152"])
    p.add_argument("-b", "--batch-size", type=int, default=128,
                   help="per-device batch size")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--iters", type=int, default=100,
                   help="iterations per epoch (synthetic data)")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--lr-decay-epochs", type=int, default=30,
                   help="epoch period of the reference's step decay "
                        "(lr * 0.1^(epoch//N), main_amp.py:490-501)")
    p.add_argument("--warmup-epochs", type=int, default=0,
                   help="linear LR warmup epochs")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--target-acc", type=float, default=None,
                   help="exit non-zero unless final val Prec@1 reaches "
                        "this (convergence gate)")
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--opt-level", default="O2")
    p.add_argument("--loss-scale", default=None)
    p.add_argument("--keep-batchnorm-fp32", default=None)
    p.add_argument("--half-dtype", default=None,
                   choices=[None, "bfloat16", "float16"])
    p.add_argument("--stem", default="conv7",
                   choices=["conv7", "space_to_depth"],
                   help="stem form: torchvision's 7x7/s2 conv or its exact "
                        "space-to-depth rewrite (models.stem_weight_to_s2d)")
    p.add_argument("--channels-last", action="store_true",
                   help="run the whole pipeline NHWC: loader delivery, "
                        "model input and every internal activation")
    p.add_argument("--sync_bn", action="store_true",
                   help="convert BatchNorm to SyncBatchNorm")
    p.add_argument("--fused-adam", action="store_true",
                   help="use FusedAdam instead of SGD")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1 optimizer-state sharding over the ranks")
    p.add_argument("--prof", action="store_true",
                   help="write a torch.profiler trace of iterations 10-19")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="save an epoch checkpoint here (keep last 3)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _gather_window(optimizer, t):
    """A ZeRO window of every rank gathered, cut to the unpadded length."""
    z = optimizer._zero
    whole = t.new_empty(z.padded)
    dist.all_gather_into_tensor(whole, t.contiguous())
    return whole[:optimizer.masters.layout.total]


def optimizer_state(optimizer):
    """The optimizer's state dict with whole arrays: under ZeRO every
    rank's windows gathered (a collective: every rank calls it)."""
    sd = optimizer.state_dict()
    z = optimizer._zero
    if z is None:
        return sd

    def whole(v):
        if isinstance(v, dict):
            return {k: whole(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor) and v.dim() == 1 \
                and v.numel() == z.shard_n:
            return _gather_window(optimizer, v)
        return v
    return {"scalers": sd["scalers"], "inner": whole(sd["inner"]),
            "masters": whole(sd["masters"])}


def load_optimizer_state(optimizer, sd):
    """Load a state dict of whole arrays; under ZeRO each rank takes its
    window (the end padded with zeros), whatever the world size that
    saved it."""
    z = optimizer._zero
    if z is None:
        optimizer.load_state_dict(sd)
        return
    total = optimizer.masters.layout.total

    def window(v):
        if isinstance(v, dict):
            return {k: window(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor) and v.dim() == 1 \
                and v.numel() == total:
            return z.window(torch.cat([v, v.new_zeros(z.padded - total)]))
        return v
    optimizer.load_state_dict({"scalers": sd["scalers"],
                               "inner": window(sd["inner"]),
                               "masters": window(sd["masters"])})


def train_state(model, optimizer):
    """What a checkpoint holds: the model's and the optimizer's state
    dicts (the optimizer's carries the fp32 masters and the scalers),
    with whole arrays under ZeRO."""
    return {"model": model.state_dict(),
            "optimizer": optimizer_state(optimizer)}


def resume_state(ckpt_dir, model, optimizer, stem, fresh=None):
    """Load the newest checkpoint of ``ckpt_dir`` into ``model`` and
    ``optimizer`` in place and return its epoch (None when there is
    none).  Under ZeRO the parameters come from the masters, each rank's
    window of them, and the model takes its buffers.  A conv7 checkpoint
    loads into a ``space_to_depth`` model through the exact stem
    conversion, with the optimizer's moments and loss scale fresh: as it
    is, or ``fresh`` (a state dict from before any step) loaded
    (main_amp.py:294-345)."""
    last = ckpt.latest_step(ckpt_dir)
    if last is None:
        return None
    try:
        state = ckpt.restore_checkpoint(ckpt_dir,
                                        train_state(model, optimizer),
                                        step=last)
    except ValueError as e:
        # only the stem's shape is convertible; any other drift
        # (num_classes, arch) is the user's error
        if stem != "space_to_depth" or "conv1" not in str(e):
            raise
        if optimizer._zero is not None:
            raise SystemExit(
                "resuming a conv7 checkpoint into --stem space_to_depth is "
                "not supported with --zero; convert it offline with "
                "models.convert_stem_to_s2d")
        print("=> checkpoint has the conv7 stem; converting (identical "
              "function; optimizer moments and loss scale reset)")
        if fresh is not None:
            optimizer.load_state_dict(fresh)
        template = dict(model.state_dict())
        w = template["conv1.weight"]
        template["conv1.weight"] = torch.empty(
            (w.shape[0], w.shape[1] // 4, 7, 7), dtype=w.dtype)
        # the model's entries only: the stored optimizer state is for
        # another shape of conv1 and is dropped
        state = ckpt.restore_checkpoint(ckpt_dir, {"model": template},
                                        step=last)
        model.load_state_dict(models.convert_stem_to_s2d(state["model"]))
        return last
    if optimizer._zero is None:
        model.load_state_dict(state["model"])
    else:
        with torch.no_grad():
            for name, buf in model.named_buffers():
                buf.copy_(state["model"][name])
    load_optimizer_state(optimizer, state["optimizer"])
    return last


def main(argv=None):
    args = parse_args(argv)
    own_group = not dist.is_initialized()
    if own_group:
        parallel.init_process_group()       # a no-op unless launched
        if args.zero and not dist.is_initialized():
            # the sharded step's collectives need a group, of one rank here
            parallel.init_process_group(
                parallel.multiproc.local_init_method(), world_size=1,
                rank=0)
    own_group = own_group and dist.is_initialized()
    grouped = dist.is_initialized()
    try:
        return _train(args, dist.get_rank() if grouped else 0,
                      dist.get_world_size() if grouped else 1)
    finally:
        amp.set_policy(amp.NoPolicy())      # O1's cast policy is global
        if own_group:
            dist.destroy_process_group()


def _train(args, rank, world):
    device = resolve_device(None if args.device == "cuda" else args.device)
    tag = f"[rank {rank}] " if world > 1 else ""

    def say(msg):
        print(tag + msg, flush=True)

    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    say(f"=> {world} rank(s) on {device} ({card})")
    say(f"=> creating model '{args.arch}'")
    fmt = "NHWC" if args.channels_last else "NCHW"
    model = getattr(models, args.arch)(
        channels_last=args.channels_last, input_format=fmt, stem=args.stem,
        device=device, generator=torch.Generator().manual_seed(args.seed))
    if args.sync_bn:
        say("using apex_tpu_torch synced BN")
        model = parallel.convert_syncbn_model(model)

    batch = args.batch_size
    global_batch = batch * world
    lo, hi = rank * batch, (rank + 1) * batch
    rng = np.random.RandomState(args.seed)
    val_images = val_labels = None
    loader = None
    if args.data:
        blob = np.load(args.data)
        if "val_images" in blob.files:
            val_images = blob["val_images"]
            val_labels = blob["val_labels"].astype(np.int64)
        if len(blob["images"]) < global_batch:
            raise SystemExit(
                f"dataset has {len(blob['images'])} images < one global "
                f"batch ({global_batch}); lower --batch-size")
        if (blob["images"].dtype == np.uint8
                and blob["images"].shape[-1] == 3):
            # NHWC uint8 -> the prefetching pipeline (C++ worker threads
            # normalize and assemble batches ahead of the loop); ranks
            # take their shard of each global batch
            loader = DataLoader(blob["images"], blob["labels"],
                                batch_size=batch, shuffle=True,
                                seed=args.seed, data_format=fmt,
                                shard_id=rank, num_shards=world)
            say(f"=> native data loader: {loader.native} "
                f"({loader.batches_per_epoch} batches/epoch)")
            args.iters = min(args.iters, loader.batches_per_epoch)

            def host_batch(i):
                imgs, lbls, _ = loader.next_batch()
                return imgs, lbls
        else:
            # float blobs are NCHW by contract (uint8 blobs are NHWC)
            images_all = blob["images"].astype(np.float32)
            if images_all.shape[1] != 3:
                raise SystemExit(
                    f"float image blobs must be NCHW with C=3, got "
                    f"shape {images_all.shape}")
            if fmt == "NHWC":
                images_all = np.ascontiguousarray(
                    images_all.transpose(0, 2, 3, 1))
            labels_all = blob["labels"].astype(np.int64)
            n_batches = len(images_all) // global_batch
            args.iters = min(args.iters, n_batches)

            def host_batch(i):
                s = (i % n_batches) * global_batch
                return (images_all[s + lo:s + hi],
                        labels_all[s + lo:s + hi])
    else:
        shape = ((global_batch, args.image_size, args.image_size, 3)
                 if fmt == "NHWC"
                 else (global_batch, 3, args.image_size, args.image_size))
        images_all = rng.randn(*shape).astype(np.float32)
        labels_all = rng.randint(0, 1000, global_batch).astype(np.int64)
        # one batch, pinned once, copied to the device each step
        x_host = torch.from_numpy(images_all[lo:hi])
        y_host = torch.from_numpy(labels_all[lo:hi])
        if device.type == "cuda":
            x_host, y_host = x_host.pin_memory(), y_host.pin_memory()

        def host_batch(i):
            return x_host, y_host

    def to_device(imgs, lbls):
        x, y = torch.as_tensor(imgs), torch.as_tensor(lbls)
        if device.type == "cuda":
            # the loader hands out owned copies (zero_copy off), so the
            # slot the copy reads cannot be recycled under it
            x = x if x.is_pinned() else x.pin_memory()
            y = y if y.is_pinned() else y.pin_memory()
        return (x.to(device, non_blocking=True),
                y.to(device, torch.int64, non_blocking=True))

    # fail misconfigurations at startup, not after an epoch of training
    if args.target_acc is not None and val_images is None:
        raise SystemExit("--target-acc set but the data blob has no "
                         "val_images/val_labels split: the gate would "
                         "silently never run")
    if val_images is not None and len(val_images) < global_batch:
        raise SystemExit(f"val split ({len(val_images)}) smaller than one "
                         f"global batch ({global_batch}); lower "
                         f"--batch-size")
    val_x = None
    if val_images is not None:
        if val_images.dtype == np.uint8 and val_images.shape[-1] == 3:
            val_x = _native.preprocess_images(val_images, IMAGENET_MEAN,
                                              IMAGENET_STD, fmt)
        else:
            val_x = val_images.astype(np.float32)
            if fmt == "NHWC":
                val_x = np.ascontiguousarray(val_x.transpose(0, 2, 3, 1))

    # the reference's step decay lr * 0.1^(epoch // N) and an optional
    # linear warmup, from the optimizer's step counter on the device: no
    # host sync
    iters_per_epoch = max(args.iters, 1)

    def lr_schedule(step):
        epoch = torch.div(step, iters_per_epoch, rounding_mode="floor")
        decay = torch.div(epoch, args.lr_decay_epochs, rounding_mode="floor")
        lr = args.lr * torch.pow(0.1, decay.to(torch.float32))
        if args.warmup_epochs:
            warm = args.warmup_epochs * iters_per_epoch
            lr = lr * torch.clamp_max((step + 1.0) / warm, 1.0)
        return lr

    if args.fused_adam:
        optimizer = optimizers.FusedAdam(lr=lr_schedule,
                                         weight_decay=args.weight_decay)
    else:
        optimizer = optimizers.SGD(lr=lr_schedule, momentum=args.momentum,
                                   weight_decay=args.weight_decay)
    model, optimizer = amp.initialize(
        model, optimizer, opt_level=args.opt_level,
        keep_batchnorm_fp32=args.keep_batchnorm_fp32,
        loss_scale=args.loss_scale, half_dtype=args.half_dtype,
        verbosity=1 if rank == 0 else 0)
    net = parallel.DistributedDataParallel(model) if world > 1 else model
    if args.zero:
        say("=> ZeRO-1 optimizer-state sharding over the data ranks")
        optimizer.zero_shard()

    resuming = (args.checkpoint_dir and args.resume
                and ckpt.latest_step(args.checkpoint_dir) is not None)
    # the state before any step, for a resume that converts the stem
    fresh = (_clone(optimizer.state_dict())
             if resuming and optimizer._zero is None else None)

    def step(batch):
        x, y = batch
        loss, out, grads = amp.scaled_grad(
            lambda: (lambda o: (cross_entropy(o, y), o))(net(x)), optimizer,
            has_aux=True)
        if world > 1 and not args.zero:
            grads = net.allreduce_grads(grads)
        optimizer.step(grads)           # under --zero it reduces them
        acc = (out.argmax(-1) == y).float().mean() * 100.0
        vals = torch.stack([loss, acc])
        if world > 1:
            dist.all_reduce(vals)
            vals = vals / world
        return vals

    # one CUDA graph on the GPU, the step itself on the CPU
    train = parallel.make_step(step, model)

    def train_step(batch):
        # the step's one host sync: loss and Prec@1, averaged over ranks
        return train(batch).cpu().tolist()

    def validate():
        if val_x is None:
            return None
        net.eval()
        correct = torch.zeros((), device=device)
        nvb = len(val_x) // global_batch
        with torch.no_grad():
            for i in range(nvb):
                s = i * global_batch
                x, y = to_device(val_x[s + lo:s + hi],
                                 val_labels[s + lo:s + hi])
                correct += (net(x).argmax(-1) == y).float().mean()
        net.train()
        if world > 1:
            dist.all_reduce(correct)
        return float(correct) / (nvb * world) * 100.0

    n_val_eval = (0 if val_x is None
                  else len(val_x) // global_batch * global_batch)

    warm = 2 if device.type == "cuda" else 1
    say("=> warm-up steps (the second captures the CUDA graph)..."
        if warm > 1 else "=> warm-up step...")
    t0 = time.time()
    for _ in range(warm):
        train_step(to_device(*host_batch(0)))
    say(f"=> warm-up in {time.time() - t0:.1f}s")

    start_epoch = 0
    if resuming:
        start_epoch = resume_state(args.checkpoint_dir, model, optimizer,
                                   args.stem, fresh)
        del fresh
        say(f"=> resumed from epoch {start_epoch} (reference "
            f"main_amp.py:170-185 resume flow)")
        if start_epoch >= args.epochs:
            say(f"=> nothing to do: resumed epoch {start_epoch} >= "
                f"--epochs {args.epochs}")
            return 0.0

    batch_time = AverageMeter()
    losses = AverageMeter()
    top1 = AverageMeter()
    val_acc = None
    for epoch in range(start_epoch, args.epochs):
        end = time.time()
        for i in range(args.iters):
            if args.prof and epoch == start_epoch and i == 10:
                say(f"=> profiling into {profiler.start_profile()}")
            loss, prec1 = train_step(to_device(*host_batch(i)))
            if args.prof and epoch == start_epoch and i == 19:
                say(f"=> trace written to {profiler.stop_profile()}")
            batch_time.update(time.time() - end)
            end = time.time()
            losses.update(loss)
            top1.update(prec1)
            if i % args.print_freq == 0:
                ips = global_batch / batch_time.val
                say(f"Epoch: [{epoch}][{i}/{args.iters}]  "
                    f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})  "
                    f"Speed {ips:.1f} img/s  "
                    f"Loss {losses.val:.4f} ({losses.avg:.4f})  "
                    f"Prec@1 {top1.val:.2f}  "
                    f"scale {amp.current_loss_scale(optimizer):.0f}")
        if profiler.profiling_active():
            say(f"=> trace written to {profiler.stop_profile()}")
        val_acc = validate()
        if val_acc is not None:
            say(f" * Prec@1 {val_acc:.3f}  (epoch {epoch}, {n_val_eval} "
                f"val images)")
        if args.checkpoint_dir:
            state = train_state(model, optimizer)     # every rank gathers
            if rank == 0:
                ckpt.save_checkpoint(args.checkpoint_dir, epoch + 1, state,
                                     keep=3)
            del state
    if loader is not None:
        loader.close()
    ips = global_batch / batch_time.avg if batch_time.avg > 0 else 0.0
    say(f"=> done. avg {ips:.1f} img/s over {args.iters} iters "
        f"({ips / world:.1f} img/s/device)")
    if val_acc is None:
        val_acc = validate()
    if val_acc is not None:
        say(f"=> FINAL val Prec@1 {val_acc:.3f}")
        if args.target_acc is not None and val_acc < args.target_acc:
            raise SystemExit(
                f"convergence gate FAILED: val Prec@1 {val_acc:.2f} < "
                f"target {args.target_acc}")
        if args.target_acc is not None:
            say(f"=> convergence gate PASSED (>= {args.target_acc})")
    return ips


if __name__ == "__main__":
    main()
