'''The Hessian head in the port (ROADMAP.md A6) against the JAX package on
the CPU, and the vmap rules of the list Functions it runs through.

The port takes the Hessian as the JAX package does, forward over reverse
(torch.func.vmap of torch.func.jvp of torch.func.grad), per graph, in
blocks of hessian_block lanes. Models are small (F=16, R=8, 2
interactions, 6 atoms, fp64) with one seeded set of weights loaded into
both packages; the bar is the JAX package's own between its graph paths
(tests/test_model_parity.py): atol 1e-9. The JAX programs are compiled at
XLA's optimization level 0 (compile time; fp64 results at this bar do not
depend on it), except the bf16 reference, compiled without excess
precision as tests/test_torch_xla_reference.py compiles it.

    python tests/test_torch_hessian.py card

writes the JAX numbers of chip_smoke.py's phase 14 to
tests/reference/jax_hessian_heads.npz and prints the pinned ones (a few
minutes on the CPU).
'''
import functools
import importlib.util
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == '__main__':  # the card recipe, run as a script
    sys.path.insert(0, ROOT)

from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu_torch import NewtonNet, NewtonNetCalculator
from newtonnet_tpu_torch.layers import activations
from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
from newtonnet_tpu_torch.ops import nlist as tnl
from newtonnet_tpu_torch.ops import row_gather as trg
from newtonnet_tpu_torch.utils.params import params_to_flax

FAST = {'xla_backend_optimization_level': 0}
NO_EXCESS_PRECISION = {'xla_allow_excess_precision': False}
ATOL = 1e-9
LAYOUTS = {
    'dense': dict(graph_mode='dense'),
    'plain': dict(graph_mode='neighborlist', k_max=5),
    'cellgrid': dict(graph_mode='neighborlist', k_max=5, cell_grid=(2, 2, 2),
                     cell_capacity=6),
    'reverse': dict(graph_mode='neighborlist', k_max=5, reverse_lists=True),
    'inverse': dict(graph_mode='neighborlist', k_max=12,
                    inverse_lists=True),
    'newton3': dict(graph_mode='neighborlist', k_max=6, newton3=True),
}
# a charge head in three of the layouts, one Ewald mode each ('auto' over
# a mixed batch: a periodic box and a molecule)
EWALD = {'dense': 'auto', 'plain': 'aperiodic', 'newton3': 'periodic'}


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def frames(seed=0, B=2, N=6, L=6.0, molecule=False, aperiodic=False):
    '''B seeded frames of N atoms on a jittered 2x2x2 lattice of spacing L/2
    (no two atoms closer than 0.35 L), the second graph with one padding
    atom; periodic cubic boxes, or all molecules (aperiodic), or with
    `molecule` a box and a molecule (a mixed batch).'''
    rs = np.random.RandomState(seed)
    sites = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing='ij'),
                     -1).reshape(8, 3) * (L / 2) + L / 4
    z = rs.choice([1, 6, 8], size=(B, N)).astype(np.int64)
    z[1:, -1] = 0
    pos = np.stack([sites[rs.permutation(8)[:N]]
                    + rs.uniform(-0.075, 0.075, (N, 3)) * L
                    for _ in range(B)])
    cell = np.broadcast_to(np.eye(3) * L, (B, 3, 3)).copy()
    if molecule:
        cell[1] = 0.0
    if aperiodic:
        cell[:] = 0.0
    return z, pos, cell


def models(layout, outputs=('energy', 'hessian'), dtype=torch.float64,
           **kw):
    '''(port model, its JAX twin, the flax tree of its weights).'''
    cfg = dict(dict(cutoff=3.5, n_features=16, n_basis=8, n_interactions=2,
                    output_properties=list(outputs), ewald_n_k=2,
                    ewald_sigma=1.2, **LAYOUTS[layout]), **kw)
    tm = NewtonNet(**cfg, device='cpu', dtype=dtype,
                   generator=torch.Generator().manual_seed(3))
    return tm, JaxNewtonNet(**cfg), params_to_flax(tm.core)


def request(tm, layout, z, pos, cell, dtype=torch.float64):
    '''Port tensors and the list a request of this layout gets.'''
    t = (torch.from_numpy(z), torch.from_numpy(pos).to(dtype),
         torch.from_numpy(cell).to(dtype))
    nl = host_symmetric_nlist(tm, *t, skin=0.0) \
        if layout in ('inverse', 'newton3') else None
    return t, nl


def jax_out(jm, params, z, pos, cell, nlist=None, dtype=np.float64,
            options=FAST):
    jnl = None if nlist is None else tuple(jnp.asarray(t.numpy())
                                           for t in nlist)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    fn = jax.jit(lambda p, a, b, c, n: jm.apply(p, a, b, c, nlist=n),
                 compiler_options=options)
    out = fn(params, jnp.asarray(z, jnp.int32), jnp.asarray(pos, dtype),
             jnp.asarray(cell, dtype), jnl)
    return {k: np.asarray(v) for k, v in out.items()}


def layout_case(layout):
    '''(port model, JAX model, weights, z, pos, cell) of a layout's case:
    with its EWALD mode's charge head and frames where it has one.'''
    mode = EWALD.get(layout)
    kw = dict(outputs=('energy', 'charge', 'hessian'),
              ewald_mode=mode) if mode else {}
    z, pos, cell = frames(molecule=mode == 'auto',
                          aperiodic=mode == 'aperiodic')
    return models(layout, **kw) + (z, pos, cell)


@functools.lru_cache(maxsize=None)
def jax_layout_hessian(layout):
    tm, jm, params, z, pos, cell = layout_case(layout)
    _, nl = request(tm, layout, z, pos, cell)
    if layout == 'reverse':
        # the JAX package's reverse-list gather is a custom_vjp, which
        # jax.jvp refuses (TypeError): its Hessian of the same model over
        # the plain list, the same function
        jm = JaxNewtonNet(**dict(tm.config_dict(), reverse_lists=False))
    return jax_out(jm, params, z, pos, cell, nl)['hessian']


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_hessian_matches_jax(layout):
    '''The port's Hessian (B, N, 3, N, 3) against the JAX package's
    apply(...)['hessian'] on every graph path at atol 1e-9 in fp64 (reverse
    lists, which the JAX package's jvp refuses, against its plain lists);
    dense,
    plain lists and newton3 half lists carry a charge head with the latent
    Ewald energy in 'auto' (a box and a molecule), 'aperiodic' and
    'periodic' mode. Symmetric to 1e-12, no cross-graph blocks, the
    padding atom's rows zero.'''
    tm, jm, params, z, pos, cell = layout_case(layout)
    t, nl = request(tm, layout, z, pos, cell)
    got = tm(*t, nlist=nl)['hessian'].numpy()
    want = jax_layout_hessian(layout)
    assert got.shape == want.shape == (2, 6, 3, 6, 3)
    assert np.abs(got - want).max() <= ATOL, np.abs(got - want).max()
    assert np.abs(got - got.transpose(0, 3, 4, 1, 2)).max() <= 1e-12
    assert not got[1, -1].any() and not got[1, ..., -1, :].any()
    assert np.abs(want).max() > 0.1


def test_hessian_blocks_match_the_unblocked_hessian():
    '''hessian_block=4 on 15 lanes (5 atoms: three blocks of 4 and a
    ragged one of 3) against the unblocked Hessian at 1e-11, over newton3
    half lists, for one graph (a calculator request: its lists fold into
    a batch of lanes whose expand the row gather's layout refuses unless
    it is copied); the block 3N and past it run all lanes at once.'''
    tm, _, _ = models('newton3')
    z, pos, cell = frames(N=5, B=1)
    t, nl = request(tm, 'newton3', z, pos, cell)
    whole = tm(*t, nlist=nl)['hessian']
    for block in (4, 15, 40):
        tm.hessian_block = block
        got = tm(*t, nlist=nl)['hessian']
        assert float((got - whole).abs().max()) <= 1e-11, block
    assert float(whole.abs().max()) > 0.1


def test_bf16_stack_hessian_at_the_jax_spread():
    '''A compute_dtype bfloat16 stack (plain lists, float32 parameters and
    positions): the port's Hessian against the JAX package's bf16 one at
    4x the JAX package's own bf16-to-fp32 spread (its fp32 Hessian is the
    fp64 one of test_hessian_matches_jax, which differs from it by float32
    rounding alone).'''
    tm, jm, params, z, pos, cell = layout_case('plain')
    bf = dict(compute_dtype='bfloat16', ewald_mode='aperiodic')
    tm16 = NewtonNet(**dict(tm.config_dict(), **bf), device='cpu')
    tm16.load_state_dict(tm.state_dict())
    jm16 = JaxNewtonNet(**dict(tm.config_dict(), **bf))
    want16 = jax_out(jm16, params, z, pos, cell, dtype=np.float32,
                     options={**FAST, **NO_EXCESS_PRECISION})['hessian']
    spread = np.abs(want16 - jax_layout_hessian('plain')).max()
    t, _ = request(tm16, 'plain', z, pos, cell, dtype=torch.float32)
    got = tm16(*t)['hessian'].double().numpy()
    assert 0 < spread < 0.1 * np.abs(want16).max()
    assert np.abs(got - want16).max() <= 4 * spread, (
        np.abs(got - want16).max(), spread)


def test_scatter_nodes_jvp_of_grad_matches_jax():
    '''The repair of ScatterNodes' missing jvp: one Hessian-vector product,
    torch.func.jvp of torch.func.grad of the energy over a plain list
    built in the model (gather_nodes, whose backward is ScatterNodes),
    against jax.jvp of jax.grad at 1e-9. Before the repair torch.func.jvp
    raised NotImplementedError here.'''
    tm, jm, params = models('plain', outputs=('energy',))
    z, pos, cell = frames()
    t, _ = request(tm, 'plain', z, pos, cell)
    v = np.random.RandomState(1).randn(*pos.shape)

    def energy(p):
        return tm._energy_and_aux(t[0], p, None, t[2])[0]
    with torch.no_grad():
        tm.requires_grad_(False)
        _, hv = torch.func.jvp(torch.func.grad(energy), (t[1],),
                               (torch.from_numpy(v),))

    params = jax.tree.map(jnp.asarray, params)

    def jenergy(p):
        return jm._energy_and_aux(params, jnp.asarray(z, jnp.int32), p,
                                  jm._identity_displacement(cell), cell)[0]
    want = jax.jit(lambda p, u: jax.jvp(jax.grad(jenergy), (p,), (u,))[1],
                   compiler_options=FAST)(jnp.asarray(pos), jnp.asarray(v))
    assert np.abs(hv.numpy() - np.asarray(want)).max() <= ATOL


def test_calculator_hessian_matches_jax_calculator():
    '''NewtonNetCalculator(properties=[energy, forces, hessian]) against
    the JAX calculator of the same model (dense, one interaction) and
    weights, one 5-atom request padded to 8: energy, forces and the (n, 3,
    n, 3) Hessian (v[0, :n, :, :n, :]) at 1e-9, in float64.'''
    from newtonnet_tpu.md.calculator import NewtonNetCalculator as JaxCalc
    tm, jm, params = models('dense', outputs=('energy', 'gradient_force'),
                            n_interactions=1)
    z, pos, cell = frames(N=5)
    props = ['energy', 'forces', 'hessian']
    req = dict(numbers=z[0], positions=pos[0], cell=cell[0])
    got = NewtonNetCalculator(model=tm, params=params, properties=props,
                              precision='float64', device='cpu') \
        .calculate(**req)
    want = JaxCalc(model=jm, params=params, properties=props,
                   precision='float64').calculate(**req)
    assert got['hessian'].shape == (5, 3, 5, 3)
    for key in props:
        assert np.abs(np.asarray(got[key]) - np.asarray(want[key])).max() \
            <= ATOL, key


@pytest.mark.parametrize('kw, text', [
    (dict(kernel='pallas', output_properties=['energy', 'hessian']),
     'kernel=pallas supports'),
    (dict(kernel='pallas', output_properties=['energy', 'direct_force']),
     'kernel=pallas supports'),
    (dict(graph_mode='neighborlist', newton3_compact=True,
          output_properties=['energy', 'hessian']),
     'newton3_compact does not support'),
])
def test_jax_refusals_kept(kw, text):
    '''The JAX package's ValueErrors for a Hessian or direct-force head it
    does not give: kernel='pallas' and newton3_compact, in both
    packages.'''
    with pytest.raises(ValueError, match=text):
        JaxNewtonNet(**kw)
    with pytest.raises(ValueError, match=text):
        NewtonNet(device='cpu', n_features=8, n_basis=4, **kw)


# ---------------------------------------------------------------- #
# the vmap rules, against a loop over the lanes


def _lists(B=2, N=6, K=4, seed=0):
    '''A symmetric-slotted list (an involution per slot) of B frames, its
    K-major form and the reverse list.'''
    rs = np.random.RandomState(seed)
    idx = np.zeros((B, N, K), np.int64)
    mask = np.zeros((B, N, K), bool)
    for b in range(B):
        for k in range(K):
            perm = rs.permutation(N)
            for a, c in zip(perm[0::2], perm[1::2]):
                if rs.rand() < 0.8:
                    idx[b, a, k], idx[b, c, k] = c, a
                    mask[b, a, k] = mask[b, c, k] = True
    idx, mask = torch.from_numpy(idx), torch.from_numpy(mask)
    return idx, mask, tnl.build_reverse_list(idx, mask)


def _functions():
    '''name -> (f(x) over a tensor x, the shape of x), each Function with
    its lists fixed.'''
    idx, mask, (rev, rev_mask) = _lists()
    B, N, K = idx.shape
    tr = tnl.node_transpose(idx, N, mask)
    kn, mask_kn = idx.transpose(1, 2).contiguous(), mask.transpose(1, 2)
    return {
        'GatherNodes': (lambda x: tnl.gather_nodes(x, idx, mask, tr),
                        (B, N, 3)),
        'ScatterNodes': (lambda y: tnl.ScatterNodes.apply(
            y, idx, mask, tr.slots, tr.valid), (B, N, K, 3)),
        'EdgeGather': (lambda x: tnl.edge_gather(x, idx, rev, rev_mask),
                       (B, N, 3)),
        'EdgePull': (lambda y: tnl.edge_pull(y, idx, rev, rev_mask),
                     (B, N, K, 3)),
        'InvGather': (lambda x: tnl.inv_gather(x, kn, kn, mask_kn),
                      (B, N, 3)),
        'InvScatterSum': (lambda y: tnl.inv_scatter_sum(y, kn, kn, mask_kn),
                          (B, K, N, 3)),
        '_Bf16Activation': (lambda x: activations.silu(
            x.to(torch.bfloat16)).to(x.dtype), (B, N, 3)),
    }


@pytest.mark.parametrize('name', list(_functions()))
def test_vmap_rule_against_a_loop_over_lanes(name):
    '''Each Function's vmap rule (the fold of the lanes into the batch
    axis) against a Python loop over 5 lanes, in every derivative order:
    the value, the vjp, the jvp and the jvp of the vjp (the Hessian's
    order), through a smooth function of the output (sin . f). Bitwise in
    fp64 (fp32 for the bf16 activation).'''
    f, shape = _functions()[name]
    dt = torch.float32 if name == '_Bf16Activation' else torch.float64
    g = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=g, dtype=dt)
    xs = torch.randn((5,) + shape, generator=g, dtype=dt)
    ts = torch.randn((5,) + shape, generator=g, dtype=dt)

    def scalar(u):
        return torch.sin(f(u)).sum()

    orders = {
        'value': lambda u, t: f(u),
        'vjp': lambda u, t: torch.func.grad(scalar)(u),
        'jvp': lambda u, t: torch.func.jvp(f, (u,), (t,))[1],
        'jvp_of_vjp': lambda u, t: torch.func.jvp(
            torch.func.grad(scalar), (u,), (t,))[1],
    }
    for order, fn in orders.items():
        for lanes_of in ('primal', 'tangent'):
            if lanes_of == 'primal':
                got = torch.func.vmap(fn)(xs, ts)
                want = torch.stack([fn(a, t) for a, t in zip(xs, ts)])
            else:  # one primal, batched tangents: the Hessian's lanes
                got = torch.func.vmap(lambda t: fn(x, t))(ts)
                want = torch.stack([fn(x, t) for t in ts])
            assert torch.equal(got, want), (name, order, lanes_of)


def _spy(monkeypatch):
    calls = []
    plain = trg.row_gather_ref

    def spy(x, idx):
        calls.append(tuple(x.shape))
        return plain(x, idx)
    monkeypatch.setattr(trg, 'row_gather_ref', spy)
    return calls


@pytest.mark.parametrize('layout', ['plain', 'newton3'])
def test_row_gather_sees_one_folded_call_per_gather_per_block(
        monkeypatch, layout):
    '''A spy on the plain row gather (what kernel K9 runs on the card):
    past the request's energy pass, with hessian_block L over B graphs,
    every call a block makes is either the primal's (batch B) or one
    folded call at L*B, each block makes the same calls, and the count
    follows the number of blocks, not of lanes: 5 blocks of 4 make 5/2 the
    calls of 2 blocks of 10 (plain lists: gather_nodes' fixed-order
    backward; newton3: inv_gather and the mirror sums). The wrapper
    refuses functorch-wrapped tensors, so every call got plain ones.'''
    tm, _, _ = models(layout, outputs=('energy',))
    z, pos, cell = frames()
    t, nl = request(tm, layout, z, pos, cell)
    calls = _spy(monkeypatch)
    tm(*t, nlist=nl)
    energy_pass = list(calls)
    h = NewtonNet(**dict(tm.config_dict(), output_properties=['hessian']),
                  device='cpu', dtype=torch.float64)
    h.load_state_dict(tm.state_dict())
    counts = {}
    for block in (4, 10):
        h.hessian_block = block
        calls.clear()
        h(*t, nlist=nl)
        assert calls[:len(energy_pass)] == energy_pass
        blocks = calls[len(energy_pass):]
        n_blocks = -(-18 // block)
        per = blocks[:len(blocks) // n_blocks]
        assert per and blocks == per * n_blocks
        assert {c[0] for c in per} == {2, 2 * block}
        counts[block] = len(blocks)
    assert counts[4] * 2 == counts[10] * 5


def test_row_gather_refuses_functorch_wrapped_tensors():
    '''The wrapper raises on a batched or dual tensor rather than gathering
    (on the card: launching K9 on its storage).'''
    x = torch.randn(2, 5, 3)
    idx = torch.tensor([[0, 4, 1], [2, 2, 3]])
    with pytest.raises(TypeError, match='torch.func-wrapped'):
        torch.func.vmap(lambda u: trg.row_gather(u[None], idx[:1]))(x)
    with pytest.raises(TypeError, match='torch.func-wrapped'):
        torch.func.jvp(lambda u: trg.row_gather(u, idx), (x,), (x,))
    assert torch.equal(trg.row_gather(x, idx), trg.row_gather_ref(x, idx))
    assert [trg.vector_bytes(n, 0, 32) for n in (48, 12, 6, 3)] == \
        [16, 4, 2, 1]
    assert trg.vector_bytes(48, 4, 0) == 4


# ---------------------------------------------------------------- #
# the card recipe


def jax_lj_rows(cs):
    '''JAX_LJ_HESSIAN_ROWS (float32) and _FP64: d grad / d pos[a, d] of the
    newton3 LJ checkpoint on lj_box(cs.LJ_HESSIAN_ATOMS) for the atoms a of
    cs.LJ_HESSIAN_ATOMS_PICKED, as the JAX package's HVPs (jax.jvp of its
    per-graph position gradient) with unit seeds, over its host-built half
    lists.'''
    from newtonnet_tpu.md.driver import host_symmetric_nlist as jax_lists
    from newtonnet_tpu.utils import checkpoint as jckpt
    z, pos, cell, _, _ = cs.lj_box(n_atoms=cs.LJ_HESSIAN_ATOMS)
    seeds = np.zeros((9,) + pos.shape[1:])
    for r, (atom, d) in enumerate((a, d) for a in cs.LJ_HESSIAN_ATOMS_PICKED
                                  for d in range(3)):
        seeds[r, atom, d] = 1.0
    ref = {}
    for prec, name in (('float32', 'JAX_LJ_HESSIAN_ROWS'),
                       ('float64', 'JAX_LJ_HESSIAN_ROWS_FP64')):
        jax.config.update('jax_enable_x64', prec == 'float64')
        jm, params = jckpt.load_model(cs.LJ_CKPT)
        params = jax.tree.map(lambda a: jnp.asarray(a, prec), params)
        p0, c0 = pos.astype(prec), cell.astype(prec)
        nl = jax_lists(jm, z, p0, c0, skin=0.0)
        nl1 = tuple(jnp.asarray(a[0]) for a in nl)

        def grad_fn(p, jm=jm, params=params, c0=c0, nl1=nl1):
            return jm._single_graph_pos_grad(
                params, jnp.asarray(z[0]), p, jnp.asarray(c0[0]), nl1)
        with jax.default_matmul_precision('highest'):
            rows = jax.jit(jax.vmap(lambda v: jax.jvp(
                grad_fn, (jnp.asarray(p0[0]),), (v,))[1]))(
                    jnp.asarray(seeds.astype(prec)))
        ref[name] = np.asarray(rows)
    jax.config.update('jax_enable_x64', False)
    return ref


def card_numbers():
    '''The JAX package's numbers of chip_smoke.py phase 14, written to
    HESSIAN_REF: 14a the aspirin checkpoint's Hessians of the first
    HESSIAN_FRAMES test frames through the JAX calculator in float32 and
    float64 (their largest difference sets 14a's bar); 14b rows of the
    newton3 LJ checkpoint's Hessian on lj_box(LJ_HESSIAN_ATOMS), as HVPs
    with unit seeds at the atoms LJ_HESSIAN_ATOMS_PICKED; 14c the aspirin
    checkpoint with direct_force_tree's head, its direct forces on the
    first DIRECT_FRAMES frames and its 10 standard fine-tuning steps; 14d
    the ensemble ENSEMBLE_CKPTS through the JAX calculator on ENSEMBLE
    requests and its MAE over the first ENSEMBLE_MAE_FRAMES frames.'''
    import test_torch_heads as heads

    from newtonnet_tpu.md.calculator import NewtonNetCalculator as JaxCalc
    from newtonnet_tpu.utils import checkpoint as jckpt
    from newtonnet_tpu_torch.data.loader import parse_xyz
    cs = chip_smoke()
    ref = {}
    samples = parse_xyz(cs.XYZ)
    h32, h64 = [], []
    for prec, out in (('float32', h32), ('float64', h64)):
        jax.config.update('jax_enable_x64', prec == 'float64')
        jm, params = jckpt.load_model(cs.XLA_CKPT)
        calc = JaxCalc(model=jm, params=params,
                       properties=cs.HESSIAN_PROPS, precision=prec)
        for s in samples[:cs.HESSIAN_FRAMES]:
            out.append(calc.calculate(numbers=s['z'],
                                      positions=s['pos'])['hessian'])
    jax.config.update('jax_enable_x64', False)
    ref['JAX_ASPIRIN_HESSIAN'] = np.stack(h32)
    ref['JAX_ASPIRIN_HESSIAN_FP64'] = np.stack(h64)
    ref['JAX_ASPIRIN_FREQS'] = cs.harmonic_eigenvalues(
        np, h64[0], samples[0]['z'])
    ref.update(jax_lj_rows(cs))
    ref.update(heads.card_direct_force(cs))
    ref.update(heads.card_ensemble(cs))
    np.savez(cs.HESSIAN_REF, **{k: np.asarray(v) for k, v in ref.items()})
    for k, v in ref.items():
        print(k, np.shape(v), 'max |.|', float(np.abs(v).max()), flush=True)
    print('fp32-to-fp64 spread of the aspirin Hessians:',
          float(np.abs(ref['JAX_ASPIRIN_HESSIAN']
                       - ref['JAX_ASPIRIN_HESSIAN_FP64']).max()))
    losses, norms = heads.jax_direct_force_steps(cs)
    print('JAX_DIRECT_STEP_LOSS =', [float(f'{v:.7g}') for v in losses])
    print('JAX_DIRECT_STEP_GRAD_NORM =',
          [float(f'{v:.5g}') for v in norms], flush=True)


if __name__ == '__main__':
    jax.config.update('jax_platforms', 'cpu')
    warnings.simplefilter('ignore')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:] == ['card']:
        card_numbers()
    else:
        sys.exit('usage: test_torch_hessian.py card')
