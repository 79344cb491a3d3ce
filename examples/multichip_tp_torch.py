"""Tensor-parallel + data-parallel generation with the port.

The counterpart of examples/multichip_tp.py: ``dp x tp`` ranks on
``torch.distributed``. The pipeline takes a (data, model) mesh: the MMDiT
and the T5 load column/row-split over the model axis (the reference's
Megatron rules, parallel/sharding.py), CLIP and the VAE whole on every
rank, and the batch of prompts splits over the data axis; each rank returns
every image, and rank 0 of each model group saves its data group's one.

NCCL where the machine has ``dp * tp`` cards (rank i on card i):

    python examples/multichip_tp_torch.py --dp 2 --tp 2

gloo, and every rank on the CPU (tiny models are the practical size there):

    python examples/multichip_tp_torch.py --dp 2 --tp 2 --device cpu

Nothing tells a program of its cluster: this script starts the ranks itself
and gives ``init_distributed`` a ``file://`` rendezvous, the world size and
each rank.
"""

import argparse
import sys
import tempfile
from pathlib import Path

import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def run(rank: int, args, rendezvous: str) -> None:
    import torch

    from diffusionkit_tpu_torch.parallel import axis_index, create_mesh, init_distributed
    from diffusionkit_tpu_torch.pipeline import DiffusionPipeline, FluxPipeline

    world = args.dp * args.tp
    init_distributed(rendezvous, world, rank, device=args.device)
    mesh = create_mesh(args.dp, args.tp, device=args.device)
    flux = "FLUX" in args.model
    pipe = (FluxPipeline if flux else DiffusionPipeline)(
        model_version=args.model,
        shift=1.0 if flux else 3.0,
        low_memory_mode=False,
        device=args.device,
        mesh=mesh,  # the MMDiT and T5 shard at load; the batch splits over data
    )
    # One prompt a data group: each group denoises its own image.
    images = pipe.generate_images_batched(
        [args.prompt] * args.dp,
        num_steps=args.steps,
        cfg_weight=0.0 if flux else 5.0,
        latent_size=(args.size // 8, args.size // 8),
        seeds=list(range(args.dp)),
    )
    if axis_index(mesh, "model") == 0:
        i = axis_index(mesh, "data")
        images[i].save(f"tp_out_{i}.png")
        print(f"rank {rank}: wrote tp_out_{i}.png", flush=True)
    torch.distributed.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="argmaxinc/mlx-stable-diffusion-3-medium")
    ap.add_argument("--prompt", default="a photo of a cat in a wizard hat")
    ap.add_argument("--dp", type=int, default=2, help="data-parallel ways")
    ap.add_argument("--tp", type=int, default=2, help="tensor-parallel ways")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=28)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    import torch

    world = args.dp * args.tp
    if args.device == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"need {world} cards for NCCL, have {torch.cuda.device_count()} "
                         f"(--device cpu runs gloo ranks on the host)")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(run, args=(args, f"file://{tmp}/rendezvous"), nprocs=world,
                           start_method="spawn")


if __name__ == "__main__":
    main()
