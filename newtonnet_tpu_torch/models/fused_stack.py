'''NewtonNet energy over the fused pair-interaction op (primal only).

The JAX package's `models/pallas_stack.py`: the same math and masking as
the dense NewtonNetCore, with every pair-tensor operation inside the
fused op (ops/fused_dense.py: kernels K1/K2 on the card). Forces, virial
and stress are autograd of this energy (models/output.py).
'''
import torch

from newtonnet_tpu_torch.layers.representations import (
    polynomial_cutoff,
    radial_bessel,
    scaled_norm,
)
from newtonnet_tpu_torch.ops.fused_dense import fused_pair_interaction
from newtonnet_tpu_torch.ops.neighbors import dense_graph


def geometry(z, pos, cell, cutoff, n_basis, mic_mode='exact'):
    '''adj (float mask (B,N,N)), dir (B,3,N,N) and rbf (B,N,N,R), with the
    Cartesian axis leading as the fused op takes it. dir and rbf are
    differentiable in pos and cell; adj is not.'''
    disp, adj = dense_graph(pos, cell, z > 0, cutoff, mic_mode=mic_mode)
    dist, dir_edge = scaled_norm(disp, cutoff)
    rbf = polynomial_cutoff(dist) * radial_bessel(dist, n_basis)
    return (adj.to(pos.dtype), dir_edge.movedim(-1, 1).contiguous(),
            rbf.contiguous())


def apply_core(core, z, pos, cell, cutoff, mic_mode='exact', pair_op=None):
    '''Primal forward: {atom_node, force_node (B,N,3,F), atomic_energy}.'''
    adj, dir_t, rbf = geometry(z, pos, cell, cutoff, core.n_basis, mic_mode)
    return core_from_geom(core, z, adj, dir_t, rbf, pair_op=pair_op)


def core_from_geom(core, z, adj, dir_t, rbf, pair_op=None):
    '''apply_core given the geometry. pair_op defaults to the fused op;
    pair_interaction_fwd_ref (ops/fused_dense.py) runs the same layer as
    plain PyTorch ops. The node MLPs and the energy head are the
    parameter modules' own forward (silu between TorchLinears).'''
    op = pair_op or fused_pair_interaction
    z = z.long()
    B, N = z.shape
    F = core.n_features
    dtype = dir_t.dtype
    fmask = (z > 0).to(dtype)[..., None]
    atom_node = core.node_embedding[z].to(dtype) * fmask
    force_t = torch.zeros((B, 3, N, F), dtype=dtype, device=dir_t.device)
    for i, lp in enumerate(core.interactions()):
        np_ = lp.message_nodepart(atom_node)
        inv1, eq = op(np_, rbf, dir_t, adj, force_t,
                      lp.message_edgepart.kernel,
                      lp.equiv_message1.TorchLinear_0.kernel,
                      lp.equiv_message1.TorchLinear_1.kernel,
                      lp.equiv_message2.TorchLinear_0.kernel,
                      lp.equiv_message2.TorchLinear_1.kernel,
                      first_layer=(i == 0))
        atom_node = atom_node + inv1
        force_t = force_t + eq
        u = lp.equiv_update(force_t)
        atom_node = atom_node + torch.sum(force_t * u, dim=1)
    e = core.scaler_energy(core.energy_head(atom_node), z)
    return {'atom_node': atom_node,
            'force_node': force_t.movedim(1, 2),
            'atomic_energy': e * fmask}
