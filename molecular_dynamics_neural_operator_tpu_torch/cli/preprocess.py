"""Preprocessing CLI: trajectories -> electrostatic potential grids
(``molecular_dynamics_neural_operator_tpu/cli/preprocess.py``).

``--mode apbs`` runs the pdb2pqr/APBS pipeline over the trajectory lists
(``preprocess/electrostatics.py``), host orchestration of external
programs. ``--mode dh`` computes screened-Coulomb grids on the device
(``preprocess/grid.py``), which needs no external program: positions from
an HDF5 trajectory, unit charges unless a ``<traj>.charges.npy`` lies
beside it, the grid centred on the trajectory's mean position. The grids
are computed on the card unless ``--device cpu`` is given.

    python -m molecular_dynamics_neural_operator_tpu_torch.cli.preprocess \\
        --mode dh --pdb_files x.pdb --traj_files traj.h5 \\
        --scratch_dir /tmp/s --results_dir grids
"""

from __future__ import annotations

import argparse
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pdb_files", type=Path, nargs="+", required=True)
    p.add_argument("--traj_files", type=Path, nargs="+", required=True)
    p.add_argument("--scratch_dir", type=Path, required=True)
    p.add_argument("--results_dir", type=Path, required=True)
    p.add_argument("--num_workers", type=int, default=10)
    p.add_argument("--save_interval", type=int, default=1000)
    p.add_argument("--mode", choices=["apbs", "dh"], default="apbs")
    p.add_argument("--pdb2pqr_exe", default="pdb2pqr30")
    p.add_argument("--apbs_exe", default="apbs")
    # dh-mode grid geometry (defaults match the APBS deck's fine grid)
    p.add_argument("--grid_lengths", type=float, nargs=3,
                   default=[52.958, 44.009, 38.33])
    p.add_argument("--grid_dime", type=int, nargs=3, default=[97, 65, 65])
    p.add_argument("--device", default=None,
                   help="(dh mode) cuda (default; a missing card is an "
                        "error) or cpu")
    return p.parse_args(argv)


def dh_grids(positions, charges, lengths, dime, device):
    """(T, *dime) f32 numpy grids of a (T, N, 3) trajectory on ``device``,
    the grid centred on the mean position."""
    import numpy as np
    import torch

    from molecular_dynamics_neural_operator_tpu_torch.preprocess.grid import (
        batched_debye_huckel_grids,
        make_grid,
    )

    center = np.asarray(positions).mean(axis=(0, 1))
    grid = make_grid(center, lengths, tuple(dime), device=device)
    phis = batched_debye_huckel_grids(
        torch.as_tensor(np.asarray(positions, np.float32), device=device),
        torch.as_tensor(np.asarray(charges, np.float32), device=device),
        grid)
    return phis.reshape((len(positions),) + tuple(dime)).cpu().numpy()


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "apbs":
        from molecular_dynamics_neural_operator_tpu_torch.preprocess.electrostatics import (  # noqa: E501
            parallel_trajectory_to_electrostatic_grid,
        )

        written = parallel_trajectory_to_electrostatic_grid(
            args.pdb_files,
            args.traj_files,
            args.scratch_dir,
            args.results_dir,
            num_workers=args.num_workers,
            save_interval=args.save_interval,
            pdb2pqr_exe=args.pdb2pqr_exe,
            apbs_exe=args.apbs_exe,
        )
        print(f"wrote {len(written)} grid chunks")
        return written

    import numpy as np

    from molecular_dynamics_neural_operator_tpu_torch.data import (
        load_trajectory,
    )
    from molecular_dynamics_neural_operator_tpu_torch.device import (
        resolve_device,
    )

    device = resolve_device(args.device)
    written = []
    args.results_dir.mkdir(parents=True, exist_ok=True)
    for traj_path in args.traj_files:
        traj = load_trajectory(traj_path)
        charges_path = Path(traj_path).with_suffix(".charges.npy")
        charges = (np.load(charges_path) if charges_path.exists()
                   else np.ones(traj.num_residues, np.float32))
        out = args.results_dir / (Path(traj_path).stem + "_dh.npy")
        np.save(out, dh_grids(traj.positions, charges, args.grid_lengths,
                              args.grid_dime, device))
        written.append(out)
        print(f"wrote {out}")
    return written


if __name__ == "__main__":
    main()
