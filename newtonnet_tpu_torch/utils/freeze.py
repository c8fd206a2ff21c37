'''Freeze flags of a pretrained warm start (the JAX package's
utils/freeze.py): parameter groups stop training. The JAX package zeroes
their gradients through an optax mask; here they get requires_grad False,
so they have no gradient and the optimizer leaves them as they are.'''


def group_frozen(name, freeze_encoder=False, freeze_interaction=False,
                 freeze_decoder=False, freeze_scaler=False):
    '''Whether the top-level parameter group `name` is frozen: encoder ->
    node_embedding, interaction -> interaction_*, decoder -> *_head,
    scaler -> scaler_*.'''
    if name == 'node_embedding':
        return freeze_encoder
    if name.startswith('interaction_'):
        return freeze_interaction
    if name.endswith('_head'):
        return freeze_decoder
    if name.startswith('scaler_'):
        return freeze_scaler
    return False


def apply_freeze(core, **flags):
    '''requires_grad_(False) on every parameter of a frozen group of the
    NewtonNetCore `core` (flags as group_frozen's). Returns the core.'''
    for name, param in core.named_parameters():
        if group_frozen(name.split('.')[0], **flags):
            param.requires_grad_(False)
    return core
