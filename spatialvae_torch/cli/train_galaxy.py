"""Train a spatial-VAE on galaxy (colour) image sets — counterpart of
``spatialvae_tpu/cli/train_galaxy.py``, flag for flag, on the CUDA card
unless ``-d -1``:

    python -m spatialvae_torch.cli.train_galaxy train.npy test.npy \
        [-z 20] [--augment_rotation] [--vanilla] [--int8-decoder] \
        [--num_epochs 100] [--save_prefix run] [-d -1]

The ``.npy`` stacks hold (N, n, m, 3) images on 0..255.  RGB channels run
through the whole model; ``--make_mono`` averages them to one,
``--invert_colours`` takes the negatives.  The training stack is shuffled
from ``--seed`` before anything else, ``--num_train_images`` truncates both
files (a quirk kept), and validation runs on the test file.  Rotation
augmentation rounds the rotated view onto the /255 grid (the reference's
uint8 round trip); ``--z_delay`` zeroes z for that many epochs, in the
evaluation and the image dumps too.

The run writes the ``outputs_{prefix}`` tree (``train/artifacts.py``):
``command.txt``, ``models.txt``, ``run.log`` (through ``logging``),
``images/_sample_{label}.png`` and, every ``--save_interval`` epochs, the
reconstruction, pose-stripped and prior-sample grids ``{E}_{label}.png``,
``{E}_dis_{label}.png``, ``{E}_rnd_{label}.png``; at the end both networks
in ``trained/`` (and the Adam state with ``--save-optimizer``), the three
curves, ``train.txt``/``val.txt`` and the zip archive in the working
directory.  The TSV ``Epoch ELBO BCE loss KL`` goes to stdout, the ``#``
lines to stderr.  Flags whose module is not ported yet raise before any
work (``cli/common.refuse_unported``).
"""

from __future__ import annotations

import argparse
import logging
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

LOGGING_LEVELS = {"CRITICAL": 50, "ERROR": 40, "WARNING": 30, "INFO": 20,
                  "DEBUG": 10, "NOTSET": 0}


def logging_level(name: str) -> int:
    return LOGGING_LEVELS.get(name.upper(), 20)


def print_and_log_info(logger, text: str):
    print(text)
    logger.info(text)


def galaxy_arguments(argv=None):
    parser = argparse.ArgumentParser("Train spatial-VAE on galaxy datasets")

    parser.add_argument("train_path", help="path to training data")
    parser.add_argument("test_path", help="path to testing data")

    add_arg(parser, "-z", "--z_dim", type=int, default=2,
            help="latent variable dimension (default: 2)")
    add_arg(parser, "--p_hidden_dim", type=int, default=500,
            help="dimension of hidden layers (default: 500)")
    add_arg(parser, "--p_num_layers", type=int, default=2,
            help="number of hidden layers (default: 2)")
    add_arg(parser, "--q_hidden_dim", type=int, default=5000,
            help="dimension of hidden layers (default: 5000)")
    add_arg(parser, "--q_num_layers", type=int, default=2,
            help="number of hidden layers (default: 2)")
    add_arg(parser, "-a", "--activation",
            choices=["tanh", "relu", "leakyrelu", "sigmoid"], default="tanh",
            help="activation function (default: tanh)")
    add_arg(parser, "--vanilla", action="store_true",
            help="use the standard MLP generator architecture")
    add_arg(parser, "--no_rotate", action="store_true",
            help="do not perform rotation inference")
    add_arg(parser, "--no_translate", action="store_true",
            help="do not perform translation inference")

    # --dx-prior is the upstream paper's spelling of the same quantity
    add_arg(parser, "--dx_scale", "--dx-prior", type=float, default=0.1,
            help="standard deviation of translation latent variables "
                 "(default: 0.1)")
    add_arg(parser, "--theta_prior", type=float, default=np.pi,
            help="standard deviation on rotation prior (default: pi)")

    add_arg(parser, "-l", "--learning_rate", type=float, default=1e-4,
            help="learning rate (default: 0.0001)")
    add_arg(parser, "--minibatch_size", type=int, default=100,
            help="minibatch size (default: 100)")

    add_arg(parser, "--augment_rotation", action="store_true",
            help="use data augmentation by randomly rotating images before "
                 "inference")
    add_arg(parser, "--z_delay", type=int, default=0,
            help="delay using unstructured latent variables for this many "
                 "training epochs (default: 0)")

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
    add_arg(parser, "--make_mono", action="store_true",
            help="convert rbg images to monochrome")
    add_arg(parser, "--logging_level", type=str, default="INFO",
            help="logging level (default: INFO")
    add_arg(parser, "--invert_colours", action="store_true",
            help="convert images to negatives")
    add_common_extras(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = galaxy_arguments(argv)
    run(args)


def load_galaxy(args) -> tuple:
    """(y_train (N, HW, C), y_val (M, HW, C), (n, m), C): the stacks
    loaded, averaged to one channel under --make_mono, the training stack
    shuffled from --seed, both truncated to --num_train_images, scaled to
    [0, 1] in float32 and inverted under --invert_colours."""
    print("# loading data...", file=sys.stderr)
    images_train = np.load(args.train_path)
    images_val = np.load(args.test_path)

    channels = 3
    if args.make_mono:
        images_train = np.mean(images_train, axis=3)
        channels = 1

    rng = np.random.RandomState(args.seed)
    rng.shuffle(images_train)
    if args.num_train_images > 0:
        images_train = images_train[:args.num_train_images]
        images_val = images_val[:args.num_train_images]

    n, m = images_train.shape[1:3]
    images_train = images_train.astype(np.float32) / 255.0
    images_val = images_val.astype(np.float32) / 255.0
    if args.invert_colours:
        images_train = 1.0 - images_train
        images_val = 1.0 - images_val
    return (images_train.reshape(-1, n * m, channels),
            images_val.reshape(-1, n * m, channels), (n, m), channels)


def elbo_config(args, channels: int):
    """The run's ``ElboConfig``, from its flags alone."""
    from spatialvae_torch.objectives import ElboConfig

    spatial = not args.vanilla
    return ElboConfig(rotate=spatial and not args.no_rotate,
                      translate=spatial and not args.no_translate,
                      dx_scale=args.dx_scale, theta_prior=args.theta_prior,
                      theta_mean_penalty=False, likelihood="bernoulli",
                      channels=channels, vanilla=args.vanilla,
                      fused=use_fused(args), int8=args.int8_decoder)


def run(args):
    """The run: on this process's device, or as this process's rank of the
    run's mesh (``cli/common``: ``launch_local_ranks``, ``maybe_mesh``)."""
    refuse_unported(args, elbo_config(args, 1 if args.make_mono else 3))
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

    # a mesh's other ranks keep no log (the tree is rank 0's)
    logging.basicConfig(**(dict(filename=f"{outputs.output_dir}/run.log",
                                filemode="w") if outputs.write
                           else dict(handlers=[logging.NullHandler()])),
                        format="%(asctime)s %(levelname)s:%(message)s",
                        datefmt="%Y%m%d %H:%M:%S",
                        level=logging_level(args.logging_level),
                        force=True)
    logger = logging.getLogger()
    print_and_log_info(logger, "Started")

    y_train, y_val, (n, m), channels = load_galaxy(args)
    image_dims = [n, m]
    coords = coord_grid(n, m)

    with env_scope(args.adam_moments, int8_sr=args.int8_sr), \
            fp32_precision():
        z_dim = args.z_dim
        print("# training with z-dim:", z_dim, file=sys.stderr)

        activation = resolve_activation_name(args.activation, "galaxy")
        ecfg = elbo_config(args, channels)
        if args.vanilla:
            print("# using the vanilla MLP generator architecture",
                  file=sys.stderr)
            p_cfg = VanillaGeneratorConfig(
                n=channels * n * m, latent_dim=z_dim,
                hidden_dim=args.p_hidden_dim, num_layers=args.p_num_layers,
                activation=activation)
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
                latent_dim=z_dim, hidden_dim=args.p_hidden_dim,
                n_out=channels, num_layers=args.p_num_layers,
                activation=activation)

        q_cfg = InferenceConfig(n=channels * n * m, latent_dim=inf_dim,
                                hidden_dim=args.q_hidden_dim,
                                num_layers=args.q_num_layers,
                                activation=activation)
        outputs.write_model_specs(
            [torch_style_repr(p_cfg), torch_style_repr(q_cfg)])

        print(f"# using priors: theta={args.theta_prior}, dx={args.dx_scale}",
              file=sys.stderr)

        tcfg = TrainConfig(minibatch_size=args.minibatch_size,
                           learning_rate=args.learning_rate,
                           num_epochs=args.num_epochs, z_delay=args.z_delay,
                           augment_rotation=args.augment_rotation,
                           # the reference's float -> uint8 -> float
                           # round trip of the rotated view
                           augment_uint8=True,
                           seed=args.seed, compute_dtype=args.compute_dtype,
                           image_shape=(n, m), channels=channels)
        trainer = Trainer(q_cfg, p_cfg, ecfg, tcfg, coords, device=device,
                          mesh=mesh, debug_nans=args.debug_nans)
        start_epoch = maybe_resume(trainer, args)

        data_train = make_dataset(y_train, device=device)
        data_val = make_dataset(y_val, device=device)
        label = save_label(vars(args), args.save_prefix)

        if outputs.write:
            save_image_grid(y_val[:args.minibatch_size],
                            f"{outputs.output_dir}/images/_sample_{label}.png",
                            image_dims)

        def dump(epoch_str, z_scale):
            dump_images(trainer, data_val, args.minibatch_size, z_dim,
                        z_scale, image_dims, outputs.output_dir, epoch_str,
                        label)

        results = image_epochs(trainer, data_train, data_val, args,
                               start_epoch, dump)
        save_image_run(trainer, args, outputs, results)
        outputs.finish()

        print_and_log_info(logger, "Finished")
        for hndlr in logger.handlers:
            hndlr.flush()
            hndlr.close()

        # the archive holds the closed log
        outputs.archive()


def dump_images(trainer, data_val, batch_size, z_dim, z_scale, image_dims,
                output_dir, epoch_str, label):
    """The reconstruction, pose-stripped and prior-sample grids of the first
    validation batch."""
    from spatialvae_torch.io.png import save_image_grid

    y = data_val.y[:batch_size]
    y_hat = trainer.reconstruct(y, z_scale=z_scale)
    y_dis = trainer.reconstruct_canonical(y, z_scale=z_scale)
    y_rnd = trainer.sample_prior(y.shape[0], z_dim, z_scale=z_scale)
    save_image_grid(y_dis, f"{output_dir}/images/{epoch_str}_dis_{label}.png",
                    image_dims)
    save_image_grid(y_hat, f"{output_dir}/images/{epoch_str}_{label}.png",
                    image_dims)
    save_image_grid(y_rnd, f"{output_dir}/images/{epoch_str}_rnd_{label}.png",
                    image_dims)


if __name__ == "__main__":
    main()
