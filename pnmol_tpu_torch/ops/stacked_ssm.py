"""Block-diagonal stacking of several IWP processes into one state space
(counterpart of :mod:`pnmol_tpu.ops.stacked_ssm`).

When all stacked processes share the number of derivatives (the latent-force
solvers' state IWP plus latent-force IWP), the stack is itself an IWP over
the concatenated points: ``blockdiag(kron(B_1, C), kron(B_2, C)) =
kron(blockdiag(B_1, B_2), C)``. :meth:`StackedSSM.as_single_iwp` gives that
collapsed form; the dense methods are the parity API.
"""

import torch

from pnmol_tpu_torch.ops import iwp as iwp_module


class StackedSSM:
    def __init__(self, processes):
        self.processes = tuple(processes)
        self._dims = tuple(p.state_dimension for p in self.processes)

    @property
    def state_dimension(self):
        return sum(self._dims)

    @property
    def is_homogeneous(self):
        """True iff all processes share one Nordsieck order."""
        return len({p.num_derivatives for p in self.processes}) == 1

    def as_single_iwp(self):
        """Collapse a homogeneous stack into one IWP over concatenated points."""
        if not self.is_homogeneous:
            raise ValueError("Stacked processes differ in num_derivatives.")
        return iwp_module.IntegratedWienerTransition(
            num_derivatives=self.processes[0].num_derivatives,
            wiener_process_dimension=sum(
                p.wiener_process_dimension for p in self.processes
            ),
            wp_diffusion_sqrtm=torch.block_diag(
                *[p.wp_diffusion_sqrtm for p in self.processes]
            ),
        )

    # -- dense parity API -----------------------------------------------------

    @staticmethod
    def _blockdiag_pairs(pairs):
        return (torch.block_diag(*[a for a, _ in pairs]),
                torch.block_diag(*[b for _, b in pairs]))

    @property
    def preconditioned_discretize(self):
        return self._blockdiag_pairs([p.preconditioned_discretize for p in self.processes])

    def non_preconditioned_discretize(self, dt):
        return self._blockdiag_pairs(
            [p.non_preconditioned_discretize(dt) for p in self.processes]
        )

    def nordsieck_preconditioner(self, dt):
        return self._blockdiag_pairs([p.nordsieck_preconditioner(dt) for p in self.processes])

    def projection_matrix(self, derivative_to_project_onto, process_to_project_onto=None):
        if process_to_project_onto is None:
            return torch.block_diag(
                *[p.projection_matrix(derivative_to_project_onto) for p in self.processes]
            )
        proj_to_proc = self.projection_to_process(process_to_project_onto)
        proj_to_deriv = self.processes[process_to_project_onto].projection_matrix(
            derivative_to_project_onto
        )
        return proj_to_deriv @ proj_to_proc

    def projection_to_process(self, process_to_project_onto: int):
        start = sum(self._dims[:process_to_project_onto])
        stop = start + self._dims[process_to_project_onto]
        factor = self.processes[0].wp_diffusion_sqrtm
        eye = torch.eye(self.state_dimension, dtype=factor.dtype, device=factor.device)
        return eye[start:stop, :]
