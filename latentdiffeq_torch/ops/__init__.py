"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas TPU kernel
of the JAX package, each beside its plain PyTorch version."""
from ._build import build_kernels, load_kernel
from .node_cuda import (neural_field_dw_cuda, neural_field_dw_reference,
                        neural_field_sweep_cuda,
                        neural_field_sweep_reference, solve_neural_field,
                        solve_neural_field_backward_cuda,
                        solve_neural_field_backward_reference,
                        solve_neural_field_cuda,
                        solve_neural_field_reference,
                        solve_neural_field_taped_reference)
from .ode_cuda import (solve_fixed_grid_batched,
                       solve_fixed_grid_batched_affine_sweep_reference,
                       solve_fixed_grid_batched_backward_reference,
                       solve_fixed_grid_batched_bwd_cuda,
                       solve_fixed_grid_batched_cuda,
                       solve_fixed_grid_batched_interval_maps_reference,
                       solve_fixed_grid_batched_reference)
from .recurrent_cuda import (goku_heads, goku_heads_backward_cuda,
                             goku_heads_backward_reference,
                             goku_heads_bwd_cuda, goku_heads_cuda,
                             goku_heads_reference,
                             goku_heads_sweep_reference,
                             goku_heads_taped_reference, pack_goku_heads)

__all__ = ["build_kernels", "load_kernel", "solve_fixed_grid_batched",
           "solve_fixed_grid_batched_cuda",
           "solve_fixed_grid_batched_reference",
           "solve_fixed_grid_batched_bwd_cuda",
           "solve_fixed_grid_batched_backward_reference",
           "solve_fixed_grid_batched_interval_maps_reference",
           "solve_fixed_grid_batched_affine_sweep_reference", "goku_heads",
           "goku_heads_cuda", "goku_heads_bwd_cuda",
           "goku_heads_backward_cuda", "goku_heads_reference",
           "goku_heads_taped_reference", "goku_heads_sweep_reference",
           "goku_heads_backward_reference", "pack_goku_heads",
           "solve_neural_field", "solve_neural_field_cuda",
           "solve_neural_field_backward_cuda",
           "solve_neural_field_reference",
           "solve_neural_field_backward_reference",
           "solve_neural_field_taped_reference", "neural_field_sweep_cuda",
           "neural_field_sweep_reference", "neural_field_dw_cuda",
           "neural_field_dw_reference"]
