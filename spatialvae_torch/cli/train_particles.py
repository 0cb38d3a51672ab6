"""Train a spatial-VAE on particle (cryo-EM) stacks — counterpart of
``spatialvae_tpu/cli/train_particles.py``, flag for flag, on the CUDA card
unless ``-d -1``:

    python -m spatialvae_torch.cli.train_particles train.mrc test.mrc \
        [--ctf-train ctf_train.txt --ctf-test ctf_test.txt] [--fit-noise] \
        [--mask] [--normalize] [--augment-rotation] [--int8-decoder] \
        [--num-epochs 100] [--save-prefix out/run] [-d -1]

MRC/npy stacks, centre crop and whole-image normalisation, per-particle CTF
kernels on odd dims (applied per batch through FFTs on the device), the
circular pixel mask, the Gaussian or colored-noise likelihood
(``--fit-noise``), the spatial or the vanilla generator (``--vanilla``),
rotation augmentation on the device, the ``--z-delay`` curriculum,
host-resident stacks streamed a minibatch per step (``--no-preload``),
checkpoints every ``--save-interval`` epochs to the bare
prefix (written in the background; ``--save-optimizer`` adds the Adam
state), resume, and the TSV ``Epoch Split ELBO Error KL`` on stdout with
the ``#`` lines on stderr.  Float32 products run in full float32 (no
TF32) while it runs (``--matmul-precision highest``, the only one the port
takes).  Flags whose module is not ported yet raise before any work
(``cli/common.refuse_unported``).
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from spatialvae_torch.cli.common import (
    add_arg,
    add_common_extras,
    chunked_epochs,
    env_scope,
    make_dataset,
    launch_local_ranks,
    maybe_mesh,
    maybe_resume,
    rank_scope,
    refuse_unported,
    resolve_activation_name,
    resolve_cli_device,
    use_fused,
)


def particles_arguments(argv=None):
    parser = argparse.ArgumentParser(
        "Train spatial-VAE on particle datasets")

    parser.add_argument("train_path", help="path to training data")
    parser.add_argument("test_path", help="path to testing data")

    add_arg(parser, "--ctf-train",
            help="path to CTF parameters for training images")
    add_arg(parser, "--ctf-test",
            help="path to CTF parameters for testing images")
    add_arg(parser, "--scale", default=1, type=float,
            help="used to scale the ang/pix if images were binned "
                 "(default: 1)")

    add_arg(parser, "-z", "--z-dim", type=int, default=2,
            help="latent variable dimension (default: 2)")
    add_arg(parser, "--p-hidden-dim", type=int, default=500,
            help="dimension of hidden layers for generator (default: 500)")
    add_arg(parser, "--p-num-layers", type=int, default=2,
            help="number of hidden layers for generator (default: 2)")
    add_arg(parser, "--q-hidden-dim", type=int, default=500,
            help="dimension of hidden layers for inference net "
                 "(default: 500)")
    add_arg(parser, "--q-num-layers", type=int, default=2,
            help="number of hidden layers for inference net (default: 2)")
    add_arg(parser, "-a", "--activation", choices=["tanh", "relu"],
            default="tanh", help="activation function (default: tanh)")
    add_arg(parser, "--softplus", action="store_true",
            help="apply softplus activation to mean pixel output by "
                 "generator")
    add_arg(parser, "--resid", action="store_true",
            help="use residual connections in networks")
    add_arg(parser, "--expand-coords", action="store_true",
            help="also use the second power of the spatial coordinates as "
                 "features in the spatial generator network")
    add_arg(parser, "--bilinear", action="store_true",
            help="use bilinear layer between coordinate and latent in "
                 "spatial generator network")

    add_arg(parser, "--fit-noise", action="store_true",
            help="also learn the standard deviation of the noise in the "
                 "generative model")
    add_arg(parser, "--vanilla", action="store_true",
            help="use the standard MLP generator architecture")
    add_arg(parser, "--no-rotate", action="store_true",
            help="do not perform rotation inference")
    add_arg(parser, "--no-translate", action="store_true",
            help="do not perform translation inference")

    # --dx-prior is the upstream paper's spelling of the same quantity
    add_arg(parser, "--dx-scale", "--dx-prior", type=float, default=0.1,
            help="standard deviation of translation latent variables "
                 "(default: 0.1)")
    add_arg(parser, "--theta-prior", type=float, default=np.pi,
            help="standard deviation on rotation prior (default: pi)")

    add_arg(parser, "-l", "--learning-rate", type=float, default=1e-4,
            help="learning rate (default: 0.0001)")
    add_arg(parser, "--minibatch-size", type=int, default=100,
            help="minibatch size (default: 100)")

    add_arg(parser, "--augment-rotation", action="store_true",
            help="use data augmentation by randomly rotating images before "
                 "inference")
    add_arg(parser, "--z-delay", type=int, default=0,
            help="delay using unstructured latent variables for this many "
                 "training epochs (default: 0)")

    add_arg(parser, "--normalize", action="store_true",
            help="normalize the images before training")
    add_arg(parser, "-c", "--crop", type=int, default=-1,
            help="crop particles down to this size (default: -1 = unused)")

    add_arg(parser, "--save-prefix", help="path prefix to save models "
                                          "(optional)")
    add_arg(parser, "--save-interval", default=10, type=int,
            help="save frequency in epochs (default: 10)")
    add_arg(parser, "--num-epochs", type=int, default=100,
            help="number of training epochs (default: 100)")

    add_arg(parser, "-d", "--device", type=int, default=-2,
            help="compute device to use")
    add_arg(parser, "--no-preload", action="store_true",
            help="do not preload data into accelerator RAM: keep both "
                 "sets on the host and stream one minibatch per step")
    add_arg(parser, "--mask", action="store_true",
            help="apply a circular mask to the images")
    add_common_extras(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = particles_arguments(argv)
    run(args)


def circular_mask(n: int, m: int) -> np.ndarray:
    """(n*m,) float32: 1 inside the disc of radius min(n, m)/2 about the
    centre (n/2, m/2), else 0."""
    radius = min(n, m) / 2
    yy, xx = np.ogrid[:n, :m]
    dist = np.sqrt((n / 2 - yy) ** 2 + (m / 2 - xx) ** 2)
    return (dist < radius).ravel().astype(np.float32)


def elbo_config(args):
    """The run's ``ElboConfig``, from its flags alone."""
    from spatialvae_torch.objectives import ElboConfig

    spatial = not args.vanilla
    return ElboConfig(rotate=spatial and not args.no_rotate,
                      translate=spatial and not args.no_translate,
                      dx_scale=args.dx_scale, theta_prior=args.theta_prior,
                      theta_mean_penalty=False,
                      likelihood="colored" if args.fit_noise else "gaussian",
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
    import torch

    from spatialvae_torch.config import (
        InferenceConfig,
        SpatialGeneratorConfig,
        VanillaGeneratorConfig,
    )
    from spatialvae_torch.ctf import ctf_filter, parse_ctf
    from spatialvae_torch.io.image import crop as crop_stack
    from spatialvae_torch.io.image import normalize_whole
    from spatialvae_torch.io.loaders import load_images
    from spatialvae_torch.precision import fp32_precision
    from spatialvae_torch.train.checkpoint import (
        optimizer_path,
        save_optimizer,
        save_trained_models,
        wait_for_checkpoints,
    )
    from spatialvae_torch.train.trainer import TrainConfig, Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    if (args.ctf_train or args.ctf_test) and args.compute_dtype != "float32":
        raise ValueError("CTF needs --compute-dtype float32: the CTF's FFT "
                         "takes float32 or float64 (the JAX trainer refuses "
                         "the same combination)")

    num_epochs = args.num_epochs
    digits = int(math.log10(num_epochs)) + 1

    images_train = load_images(args.train_path)
    images_test = load_images(args.test_path)
    print("# train:", images_train.shape, ", test:", images_test.shape,
          file=sys.stderr)

    if args.crop > 0:
        images_train = crop_stack(images_train, args.crop)
        images_test = crop_stack(images_test, args.crop)
        print("# cropped to:", args.crop, file=sys.stderr)

    n, m = images_train.shape[1:]

    if args.normalize:
        print("# normalizing particles", file=sys.stderr)
        images_train = normalize_whole(images_train.astype(np.float32))
        images_test = normalize_whole(images_test.astype(np.float32))

    # CTF filters are built on odd dims (the reference's
    # train_particles.py:355-358)
    kn = n - 1 if n % 2 == 0 else n
    km = m - 1 if m % 2 == 0 else m
    ctf_train = ctf_test = None
    if args.ctf_train is not None:
        print("# loading CTF filters:", args.ctf_train, file=sys.stderr)
        ctf_train = ctf_filter(parse_ctf(args.ctf_train), kn, km,
                               scale=args.scale)
    if args.ctf_test is not None:
        print("# loading CTF filters:", args.ctf_test, file=sys.stderr)
        ctf_test = ctf_filter(parse_ctf(args.ctf_test), kn, km,
                              scale=args.scale)

    coords = coord_grid(n, m)
    y_train = images_train.astype(np.float32).reshape(-1, n * m)
    y_test = images_test.astype(np.float32).reshape(-1, n * m)

    mask = None
    if args.mask:
        print("# masking particles", file=sys.stderr)
        mask = circular_mask(n, m)
        print("# masking to size:", int(mask.sum()), file=sys.stderr)

    with env_scope(args.adam_moments, int8_sr=args.int8_sr), \
            fp32_precision():
        z_dim = args.z_dim
        print("# training with z-dim:", z_dim, file=sys.stderr)

        activation = resolve_activation_name(args.activation, "particles")
        ecfg = elbo_config(args)
        n_out = 2 if args.fit_noise else 1
        if args.vanilla:
            print("# using the vanilla MLP generator architecture",
                  file=sys.stderr)
            p_cfg = VanillaGeneratorConfig(
                n=n * m, latent_dim=z_dim, hidden_dim=args.p_hidden_dim,
                n_out=n_out, num_layers=args.p_num_layers,
                activation=activation, softplus=args.softplus,
                resid=args.resid)
            inf_dim = z_dim
        else:
            print("# using the spatial generator architecture",
                  file=sys.stderr)
            inf_dim = z_dim
            if ecfg.rotate:
                print("# spatial-VAE with rotation inference",
                      file=sys.stderr)
                inf_dim += 1
            if ecfg.translate:
                print("# spatial-VAE with translation inference",
                      file=sys.stderr)
                inf_dim += 2
            p_cfg = SpatialGeneratorConfig(
                latent_dim=z_dim, hidden_dim=args.p_hidden_dim, n_out=n_out,
                num_layers=args.p_num_layers, activation=activation,
                softplus=args.softplus, resid=args.resid,
                expand_coords=args.expand_coords, bilinear=args.bilinear)

        q_cfg = InferenceConfig(n=n * m, latent_dim=inf_dim,
                                hidden_dim=args.q_hidden_dim,
                                num_layers=args.q_num_layers,
                                activation=activation, resid=args.resid)

        print(f"# using priors: theta={args.theta_prior}, dx={args.dx_scale}",
              file=sys.stderr)

        tcfg = TrainConfig(minibatch_size=args.minibatch_size,
                           learning_rate=args.learning_rate,
                           num_epochs=num_epochs, z_delay=args.z_delay,
                           augment_rotation=args.augment_rotation,
                           seed=args.seed, compute_dtype=args.compute_dtype,
                           image_shape=(n, m))
        trainer = Trainer(q_cfg, p_cfg, ecfg, tcfg, coords,
                          mask=None if mask is None else torch.from_numpy(mask),
                          device=device, mesh=mesh,
                          debug_nans=args.debug_nans)
        start_epoch = maybe_resume(trainer, args)

        # --no-preload: both sets stay on the host and stream a minibatch
        # per step (the JAX CLI's train_particles.py:262-266)
        preload = not args.no_preload
        data_train = make_dataset(y_train, ctf_train, device=device,
                                  preload=preload)
        data_test = make_dataset(y_test, ctf_test, device=device,
                                 preload=preload)

        print("\t".join(["Epoch", "Split", "ELBO", "Error", "KL"]))

        for rows, epoch in chunked_epochs(
                trainer, data_train, start_epoch, num_epochs,
                getattr(args, "eval_interval", 1), args.save_interval,
                args.profile_dir):
            for e, tr in rows:
                print("\t".join([str(e + 1), "train", *map(str, tr)]),
                      flush=True)
            z_scale = 0.0 if (epoch - 1) < args.z_delay else 1.0
            va = trainer.eval_epoch(data_test, epoch - 1, z_scale=z_scale)
            print("\t".join([str(epoch), "test", *map(str, va)]),
                  flush=True)

            # per-interval checkpoints to the bare prefix; chunk_len never
            # crosses a save boundary, so the cadence survives
            # --eval-interval
            saved = save_trained_models(
                args.save_prefix, epoch - 1, digits, args.save_interval,
                None, trainer.p_net, trainer.q_net, elbo=trainer.ecfg,
                image_shape=trainer.tcfg.image_shape)
            if saved and args.save_optimizer:
                save_optimizer(
                    optimizer_path(args.save_prefix, epoch - 1, digits),
                    trainer.opt_state, epoch - 1, trainer.q_net,
                    trainer.p_net, async_write=True)

        wait_for_checkpoints()


if __name__ == "__main__":
    main()
