'''NewtonNet energy over the fused pair-interaction ops.

The JAX package's `models/pallas_stack.py`: the same math and masking as
the dense NewtonNetCore, with every pair-tensor operation inside a fused
op. Two entry points:

* core_from_geom: the primal energy over ops/fused_dense.py (kernels K1/K2
  on the card); forces, virial and stress are autograd of it
  (models/output.py).
* dual_energy_from_geom: per-graph energies and their directional
  derivative along a position tangent, in one dual-number forward over
  ops/fused_dual.py (K3/K4). Autograd of a scalar built from its outputs
  is the parameter gradient of force training (train/fastgrad.py); the
  node-level tangent arithmetic here is plain torch, differentiated by
  autograd, and the pair level goes through K4.
'''
import torch

from newtonnet_tpu_torch.layers.representations import (
    polynomial_cutoff,
    radial_bessel,
    scaled_norm,
)
from newtonnet_tpu_torch.ops.fused_dense import _dsilu, fused_pair_interaction
from newtonnet_tpu_torch.ops.fused_dual import fused_pair_interaction_dual
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


def apply_core(core, z, pos, cell, cutoff, mic_mode='exact', pair_op=None,
               dot_dtype='float32'):
    '''Primal forward: {atom_node, force_node (B,N,3,F), atomic_energy}.'''
    adj, dir_t, rbf = geometry(z, pos, cell, cutoff, core.n_basis, mic_mode)
    return core_from_geom(core, z, adj, dir_t, rbf, pair_op=pair_op,
                          dot_dtype=dot_dtype)


def core_from_geom(core, z, adj, dir_t, rbf, pair_op=None,
                   dot_dtype='float32'):
    '''apply_core given the geometry. pair_op defaults to the fused op;
    pair_interaction_fwd_ref (ops/fused_dense.py) runs the same layer as
    plain PyTorch ops. dot_dtype is the precision of the pair op's
    products (the model's pallas_dot_dtype, which the JAX package's
    pallas_stack.py hands to K1/K2). The node MLPs and the energy head are
    the parameter modules' own forward (silu between TorchLinears).'''
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
                      first_layer=(i == 0), dot_dtype=dot_dtype)
        atom_node = atom_node + inv1
        force_t = force_t + eq
        u = lp.equiv_update(force_t)
        atom_node = atom_node + torch.sum(force_t * u, dim=1)
    e = core.scaler_energy(core.energy_head(atom_node), z)
    return {'atom_node': atom_node,
            'force_node': force_t.movedim(1, 2),
            'atomic_energy': e * fmask}


def geometry_tangent(z, pos, cell, v, cutoff, n_basis, mic_mode='exact'):
    '''adj, (dir, rbf) and their tangent (dirdot, rbfdot) along the position
    tangent v (B, N, 3): the JAX package's jax.linearize of the geometry
    (train/fastgrad.py:64-80), as one forward-mode pass of torch.func.jvp.
    None of them carries a gradient.'''
    pos, v = pos.detach(), v.detach()
    adj = dense_graph(pos, cell, z > 0, cutoff, mic_mode=mic_mode)[1]

    def feats(x):
        return geometry(z, x, cell, cutoff, n_basis, mic_mode)[1:]

    (dir_t, rbf), (dirdot, rbfdot) = torch.func.jvp(feats, (pos,), (v,))
    return adj.to(pos.dtype), dir_t, rbf, dirdot.contiguous(), \
        rbfdot.contiguous()


def _mlp2_dual(mlp, x, xdot):
    '''The biased TorchLinear-silu-TorchLinear node MLP and its tangent.'''
    l0, l1 = mlp.TorchLinear_0, mlp.TorchLinear_1
    h = x @ l0.kernel + l0.bias
    y = torch.nn.functional.silu(h) @ l1.kernel + l1.bias
    return y, (_dsilu(h) * (xdot @ l0.kernel)) @ l1.kernel


def _mlp3_dual(mlp, x, xdot):
    '''The energy head F -> F -> F -> 1 (silu between) and its tangent.'''
    layers = (mlp.TorchLinear_0, mlp.TorchLinear_1, mlp.TorchLinear_2)
    for k, layer in enumerate(layers):
        if k:
            x, xdot = torch.nn.functional.silu(h), _dsilu(h) * xdot
        h = x @ layer.kernel + layer.bias
        xdot = xdot @ layer.kernel
    return h, xdot


def dual_energy_from_geom(core, z, adj, dir_t, rbf, dirdot_t, rbfdot,
                          dot_dtype='bfloat16', pair_op=None):
    '''Per-graph energies (B,) and their directional derivative along the
    position tangent that gave (dirdot_t, rbfdot), differentiable in the
    parameters. dot_dtype is the precision of the pair op's products (the
    JAX package's pallas_grad_dot_dtype); pair_op defaults to the fused dual
    op (K3/K4 on the card), and fused_pair_interaction_dual with plain=True
    (ops/fused_dual.py) runs the same layer and backward as plain PyTorch
    ops.'''
    op = pair_op or fused_pair_interaction_dual
    z = z.long()
    B, N = z.shape
    dtype = dir_t.dtype
    fmask = (z > 0).to(dtype)[..., None]
    atom_node = core.node_embedding[z].to(dtype) * fmask
    atomdot = torch.zeros_like(atom_node)
    force_t = torch.zeros((B, 3, N, core.n_features), dtype=dtype,
                          device=dir_t.device)
    forcedot_t = torch.zeros_like(force_t)
    for i, lp in enumerate(core.interactions()):
        np_, npdot = _mlp2_dual(lp.message_nodepart, atom_node, atomdot)
        inv1, eq, inv1dot, eqdot = op(
            np_, npdot, rbf, rbfdot, dir_t, dirdot_t, adj, force_t,
            forcedot_t, lp.message_edgepart.kernel,
            lp.equiv_message1.TorchLinear_0.kernel,
            lp.equiv_message1.TorchLinear_1.kernel,
            lp.equiv_message2.TorchLinear_0.kernel,
            lp.equiv_message2.TorchLinear_1.kernel,
            first_layer=(i == 0), dot_dtype=dot_dtype)
        atom_node = atom_node + inv1
        atomdot = atomdot + inv1dot
        force_t = force_t + eq
        forcedot_t = forcedot_t + eqdot
        ku = lp.equiv_update.kernel
        u = force_t @ ku
        udot = forcedot_t @ ku
        atom_node = atom_node + torch.sum(force_t * u, dim=1)
        atomdot = atomdot + torch.sum(forcedot_t * u + force_t * udot, dim=1)
    e, edot = _mlp3_dual(core.energy_head, atom_node, atomdot)
    scale = core.scaler_energy.scale[z, 0][..., None]
    shift = core.scaler_energy.shift[z, 0][..., None]
    e = (e * scale + shift) * fmask
    edot = edot * scale * fmask
    return e[..., 0].sum(-1), edot[..., 0].sum(-1)
