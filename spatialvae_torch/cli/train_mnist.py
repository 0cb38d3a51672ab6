"""Train a spatial-VAE on MNIST-style digit sets — counterpart of
``spatialvae_tpu/cli/train_mnist.py``, flag for flag, on the CUDA card
unless ``-d -1``:

    python -m spatialvae_torch.cli.train_mnist \
        [--dataset mnist-rotated-translated] [--vanilla] [-z 2] \
        [--int8-decoder] [--num_epochs 100] [--save_prefix run] [-d -1]

``--dataset`` picks the arrays under ``data/``: ``mnist-rotated``
(``data/mnist_rotated/images_{train,test}.npy``), ``mnist-rotated-
translated`` (``data/mnist_rotated_translated/...``), ``galaxy`` (the
galaxy stacks ``data/galaxy_zoo/galaxy_zoo_{train,test}.npy`` averaged to
one channel) and ``mnist`` (``data/mnist/images_{train,test}.npy``, or the
raw idx files ``train-images-idx3-ubyte`` and ``t10k-images-idx3-ubyte``,
plain or ``.gz``, in ``data/mnist/`` or ``data/mnist/MNIST/raw/``).  Where
none of those is present the run raises and says where to put them: the
port has no torchvision and no download (ROADMAP M9d).  The rotation prior
carries the mean penalty, and ``--num_layers`` sets both networks' depth.

The run writes the ``outputs_{prefix}`` tree as the galaxy CLI does
(``train/artifacts.py``), with two grids per dump (``{E}_{label}.png``,
``{E}_dis_{label}.png``) and no run log.  Flags whose module is not ported
yet raise before any work (``cli/common.refuse_unported``).
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct
import sys

import numpy as np

from spatialvae_torch.cli.common import (
    add_arg,
    add_common_extras,
    env_scope,
    image_epochs,
    make_dataset,
    launch_local_ranks,
    maybe_mesh,
    maybe_resume,
    rank_scope,
    refuse_unported,
    resolve_activation_name,
    resolve_cli_device,
    save_image_run,
    use_fused,
)


def mnist_arguments(argv=None):
    parser = argparse.ArgumentParser("Train spatial-VAE on MNIST datasets")

    add_arg(parser, "--dataset",
            choices=["mnist", "mnist-rotated", "mnist-rotated-translated",
                     "galaxy"],
            default="mnist-rotated-translated",
            help="which MNIST datset to train/validate on "
                 "(default: mnist-rotated-translated)")

    add_arg(parser, "-z", "--z_dim", type=int, default=2,
            help="latent variable dimension (default: 2)")
    add_arg(parser, "--p_hidden_dim", type=int, default=500,
            help="dimension of hidden layers (default: 500)")
    add_arg(parser, "--q_hidden_dim", type=int, default=500,
            help="dimension of hidden layers (default: 500)")
    add_arg(parser, "--num_layers", type=int, default=2,
            help="number of hidden layers (default: 2)")
    add_arg(parser, "-a", "--activation", choices=["tanh", "relu"],
            default="tanh", help="activation function (default: tanh)")

    add_arg(parser, "--vanilla", action="store_true",
            help="use the standard MLP generator architecture, decoding each "
                 "pixel with an independent function. disables structured "
                 "rotation and translation inference")
    add_arg(parser, "--no_rotate", action="store_true",
            help="do not perform rotation inference")
    add_arg(parser, "--no_translate", action="store_true",
            help="do not perform translation inference")

    # --dx-prior is the upstream paper's spelling of the same quantity
    add_arg(parser, "--dx_scale", "--dx-prior", type=float, default=0.1,
            help="standard deviation of translation latent variables "
                 "(default: 0.1)")
    add_arg(parser, "--theta_prior", type=float, default=np.pi / 4,
            help="standard deviation on rotation prior (default: pi/4)")

    add_arg(parser, "-l", "--learning_rate", type=float, default=1e-4,
            help="learning rate (default: 0.0001)")
    add_arg(parser, "--minibatch_size", type=int, default=100,
            help="minibatch size (default: 100)")

    add_arg(parser, "--save_prefix", help="path prefix to save models "
                                          "(optional)")
    add_arg(parser, "--save_interval", default=10, type=int,
            help="save frequency in epochs (default: 10)")
    add_arg(parser, "--num_epochs", type=int, default=100,
            help="number of training epochs (default: 100)")

    add_arg(parser, "-d", "--device", type=int, default=-2,
            help="compute device to use")
    add_arg(parser, "--num_train_images", type=int, default=0,
            help="number of training images (default: 0 = all)")
    add_arg(parser, "--val_split", type=int, default=50,
            help="%% split of training images for validation instead of "
                 "training (default: 50)")
    add_common_extras(parser)
    return parser.parse_args(argv)


def load_mnist_idx(root: str):
    """(train, test) uint8 (N, rows, cols) arrays from the raw idx3-ubyte
    image files (plain or .gz) in ``root`` or ``root/MNIST/raw``, or None
    when either is missing."""

    def read_images(name):
        for base in (root, os.path.join(root, "MNIST", "raw")):
            for suffix, opener in (("", open), (".gz", gzip.open)):
                path = os.path.join(base, name + suffix)
                if os.path.exists(path):
                    with opener(path, "rb") as f:
                        magic, n, rows, cols = struct.unpack(
                            ">IIII", f.read(16))
                        if magic != 2051:
                            return None
                        data = np.frombuffer(f.read(n * rows * cols),
                                             dtype=np.uint8)
                        return data.reshape(n, rows, cols)
        return None

    train = read_images("train-images-idx3-ubyte")
    test = read_images("t10k-images-idx3-ubyte")
    if train is not None and test is not None:
        return train, test
    return None


def load_mnist_arrays(dataset: str, data_root: str = "data"):
    """(train, test) image arrays of ``dataset`` under ``data_root``."""
    if dataset == "mnist":
        print("# training on MNIST", file=sys.stderr)
        npy = f"{data_root}/mnist/images_train.npy"
        if os.path.exists(npy):
            return (np.load(npy),
                    np.load(f"{data_root}/mnist/images_test.npy"))
        idx = load_mnist_idx(f"{data_root}/mnist")
        if idx is not None:
            return idx
        raise RuntimeError(
            f"no MNIST arrays: place images_train.npy/images_test.npy, or "
            f"the raw idx files train-images-idx3-ubyte and "
            f"t10k-images-idx3-ubyte (plain or .gz), under "
            f"{data_root}/mnist/; the port does not download them (ROADMAP "
            f"M9d)")
    if dataset == "mnist-rotated":
        print("# training on rotated MNIST", file=sys.stderr)
        return (np.load(f"{data_root}/mnist_rotated/images_train.npy"),
                np.load(f"{data_root}/mnist_rotated/images_test.npy"))
    if dataset == "galaxy":
        print("# training on mono-chromed galaxy_zoo", file=sys.stderr)
        train = np.load(f"{data_root}/galaxy_zoo/galaxy_zoo_train.npy")
        test = np.load(f"{data_root}/galaxy_zoo/galaxy_zoo_test.npy")
        return np.mean(train, axis=3), np.mean(test, axis=3)
    print("# training on rotated and translated MNIST", file=sys.stderr)
    return (
        np.load(f"{data_root}/mnist_rotated_translated/images_train.npy"),
        np.load(f"{data_root}/mnist_rotated_translated/images_test.npy"))


def main(argv=None):
    args = mnist_arguments(argv)
    run(args)


def elbo_config(args):
    """The run's ``ElboConfig``, from its flags alone."""
    from spatialvae_torch.objectives import ElboConfig

    spatial = not args.vanilla
    return ElboConfig(rotate=spatial and not args.no_rotate,
                      translate=spatial and not args.no_translate,
                      dx_scale=args.dx_scale, theta_prior=args.theta_prior,
                      theta_mean_penalty=True, likelihood="bernoulli",
                      vanilla=args.vanilla, fused=use_fused(args),
                      int8=args.int8_decoder)


def run(args):
    """The run: on this process's device, or as this process's rank of the
    run's mesh (``cli/common``: ``launch_local_ranks``, ``maybe_mesh``)."""
    refuse_unported(args, elbo_config(args))
    device = resolve_cli_device(args.device)
    if launch_local_ranks(args, device, run):
        return
    mesh = maybe_mesh(args, device)
    with rank_scope(mesh):
        _train(args, device if mesh is None else mesh.device, mesh)


def _train(args, device, mesh):
    from spatialvae_torch.config import (
        InferenceConfig,
        SpatialGeneratorConfig,
        VanillaGeneratorConfig,
    )
    from spatialvae_torch.io.png import save_image_grid
    from spatialvae_torch.models.reprs import torch_style_repr
    from spatialvae_torch.precision import fp32_precision
    from spatialvae_torch.train.artifacts import RunOutputs, save_label
    from spatialvae_torch.train.trainer import TrainConfig, Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    outputs = RunOutputs(args.save_prefix,
                         write=mesh is None or mesh.rank == 0)
    outputs.write_command(vars(args))

    images_train, images_test = load_mnist_arrays(args.dataset)
    n, m = images_train.shape[1:3]
    image_dims = [n, m]
    y_train = images_train.astype(np.float32).reshape(-1, n * m) / 255.0
    y_test = images_test.astype(np.float32).reshape(-1, n * m) / 255.0
    coords = coord_grid(n, m)

    with env_scope(args.adam_moments, int8_sr=args.int8_sr), \
            fp32_precision():
        z_dim = args.z_dim
        print("# training with z-dim:", z_dim, file=sys.stderr)

        activation = resolve_activation_name(args.activation, "mnist")
        ecfg = elbo_config(args)
        if args.vanilla:
            print("# using the vanilla MLP generator architecture",
                  file=sys.stderr)
            p_cfg = VanillaGeneratorConfig(
                n=n * m, latent_dim=z_dim, hidden_dim=args.p_hidden_dim,
                num_layers=args.num_layers, activation=activation)
            inf_dim = z_dim
        else:
            print("# using the spatial generator architecture",
                  file=sys.stderr)
            inf_dim = z_dim
            if ecfg.rotate:
                print("# spatial-VAE with rotation inference", file=sys.stderr)
                inf_dim += 1
            if ecfg.translate:
                print("# spatial-VAE with translation inference",
                      file=sys.stderr)
                inf_dim += 2
            p_cfg = SpatialGeneratorConfig(
                latent_dim=z_dim, hidden_dim=args.p_hidden_dim, n_out=1,
                num_layers=args.num_layers, activation=activation)

        q_cfg = InferenceConfig(n=n * m, latent_dim=inf_dim,
                                hidden_dim=args.q_hidden_dim,
                                num_layers=args.num_layers,
                                activation=activation)
        outputs.write_model_specs(
            [torch_style_repr(p_cfg), torch_style_repr(q_cfg)])

        print(f"# using priors: theta={args.theta_prior}, dx={args.dx_scale}",
              file=sys.stderr)

        tcfg = TrainConfig(minibatch_size=args.minibatch_size,
                           learning_rate=args.learning_rate,
                           num_epochs=args.num_epochs, seed=args.seed,
                           compute_dtype=args.compute_dtype,
                           image_shape=(n, m))
        trainer = Trainer(q_cfg, p_cfg, ecfg, tcfg, coords, device=device,
                          mesh=mesh, debug_nans=args.debug_nans)
        start_epoch = maybe_resume(trainer, args)

        data_train = make_dataset(y_train, device=device)
        data_test = make_dataset(y_test, device=device)
        label = save_label(vars(args), args.save_prefix)

        # the input sample, before training
        if outputs.write:
            save_image_grid(y_test[:args.minibatch_size],
                            f"{outputs.output_dir}/images/_sample_{label}.png",
                            image_dims)

        def dump(epoch_str, z_scale):
            dump_images(trainer, data_test, args.minibatch_size, image_dims,
                        outputs.output_dir, epoch_str, label)

        results = image_epochs(trainer, data_train, data_test, args,
                               start_epoch, dump)
        save_image_run(trainer, args, outputs, results)
        outputs.archive()
        outputs.finish()


def dump_images(trainer, data_test, batch_size, image_dims, output_dir,
                epoch_str, label):
    """The reconstruction and pose-stripped grids of the first validation
    batch."""
    from spatialvae_torch.io.png import save_image_grid

    y = data_test.y[:batch_size]
    y_hat = trainer.reconstruct(y)
    y_dis = trainer.reconstruct_canonical(y)
    save_image_grid(y_dis, f"{output_dir}/images/{epoch_str}_dis_{label}.png",
                    image_dims)
    save_image_grid(y_hat, f"{output_dir}/images/{epoch_str}_{label}.png",
                    image_dims)


if __name__ == "__main__":
    main()
