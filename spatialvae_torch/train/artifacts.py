"""Run-output management: directories, command.txt, models.txt, results
files, zip archives — counterpart of ``spatialvae_tpu/train/artifacts.py``,
with the same names and bytes:

- ``outputs_{prefix}/`` with ``trained/`` and ``images/`` subdirs, emptied
  (after an interactive confirmation) at run start
- ``command.txt``: the reconstructed invocation line + ``key=value`` rows
- ``models.txt``: torch-style module reprs (``models/reprs.py``)
- ``train.txt`` / ``val.txt``: tab-separated per-epoch results
- ``{yymmdd_HHMM}_outputs_{prefix}.zip`` end-of-run archive, written in the
  working directory
- save-label scheme ``{prefix}_z{z}...ep{epochs}``

The confirmation prompt is skipped when stdin is not a tty or
``SPATIALVAE_ASSUME_YES=1``.
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
from pathlib import Path


def ensure_empty_directory(dir_path: str) -> None:
    """Create the directory, emptying it first if it has content."""
    p = Path(dir_path)
    if p.exists():
        for child in p.iterdir():
            if child.is_dir():
                shutil.rmtree(child)
            else:
                child.unlink()
    p.mkdir(parents=True, exist_ok=True)


def confirm_or_exit(message: str) -> None:
    if os.environ.get("SPATIALVAE_ASSUME_YES") == "1":
        return
    if not sys.stdin.isatty():
        return
    if input(message).lower() == "n":
        raise SystemExit(0)


def save_command_args_to_file(args: dict, save_path: str) -> None:
    """First line: the reconstructed 'python <script> <argv...>' invocation;
    then one ``key=value`` row per argument (the reference's format,
    including the blank line the trailing newline produces)."""
    invocation = " ".join(
        ["python", os.path.basename(sys.argv[0])] + sys.argv[1:]) + "\n"
    rows = [f"{k}={v or ''}" for k, v in args.items()]
    with open(save_path, "w", encoding="utf-8") as f:
        f.write("\n".join([invocation] + rows))
    print(f"Command arguments saved to {save_path}.")


def save_label(args_dict: dict, prefix: str) -> str:
    """``{prefix}_z{z}[pnl{..}][qnl{..}][nl{..}]ep{epochs}`` — iteration
    order follows the argparse registration order."""
    tags = {"z_dim": "z", "p_num_layers": "pnl", "q_num_layers": "qnl",
            "num_layers": "nl", "num_epochs": "ep"}
    label = (prefix or "") + "_"
    for key, value in args_dict.items():
        if key in tags:
            label += tags[key] + str(value)
    return label


class RunOutputs:
    """Owns the outputs_{prefix} tree for one training run.  With ``write``
    False (a mesh's ranks other than 0) it names the tree and touches
    nothing: its writers return at once."""

    def __init__(self, prefix: str, confirm: bool = True,
                 write: bool = True):
        self.write = write
        if confirm and write:
            confirm_or_exit("WARNING Will clear the outputs directory if it "
                            "exists. Continue (y/n and Enter)?")
        self.start_time = datetime.datetime.now()
        print(f"Start : {self.start_time.strftime('%y%m%d_%H%M%S')}")
        self.output_dir = f"outputs_{prefix}"
        self.trained_dir = os.path.join(self.output_dir, "trained")
        self.images_dir = os.path.join(self.output_dir, "images")
        if write:
            for d in (self.output_dir, self.trained_dir, self.images_dir):
                ensure_empty_directory(d)

    def write_command(self, args_dict: dict) -> None:
        if not self.write:
            return
        save_command_args_to_file(
            args_dict, os.path.join(self.output_dir, "command.txt"))

    def write_model_specs(self, reprs) -> None:
        if not self.write:
            return
        with open(os.path.join(self.output_dir, "models.txt"), "w") as f:
            for r in reprs:
                print(r, file=f)

    def write_results(self, train_lines, val_lines) -> None:
        if not self.write:
            return
        with open(os.path.join(self.output_dir, "train.txt"), "w") as f:
            print("\n".join(train_lines), file=f)
        with open(os.path.join(self.output_dir, "val.txt"), "w") as f:
            print("\n".join(val_lines), file=f)

    def archive(self) -> str:
        """Zip the whole outputs dir as {yymmdd_HHMM}_outputs_{prefix}.zip
        beside it (None when not writing)."""
        if not self.write:
            return None
        print("Archiving files...")
        stamp = datetime.datetime.now().strftime("%y%m%d_%H%M_")
        base = Path(self.output_dir)
        target = str(base.parent / (stamp + base.name))
        result = shutil.make_archive(target, "zip", base.parent, base.name)
        print(f"Images saved at {target}.zip")
        return result

    def finish(self) -> None:
        end_time = datetime.datetime.now()
        print(f"End : {end_time.strftime('%y%m%d_%H%M%S')}")
        print(f"Elapsed time: {end_time - self.start_time}")
