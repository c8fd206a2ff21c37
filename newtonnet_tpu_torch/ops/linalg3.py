'''Closed-form 3x3 determinant and inverse for lattice cells (..., 3, 3).'''
import torch


def det3x3(a):
    '''Determinant of (..., 3, 3) by cofactor expansion.'''
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                        - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                          - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                          - a[..., 1, 1] * a[..., 2, 0]))


def inv3x3(a):
    '''Inverse of (..., 3, 3) as adjugate / determinant. A singular input
    gives inf/nan entries; callers that may see zero cells guard it.'''
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = [
        [a[..., i, j] for j in range(3)] for i in range(3)]
    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    c10 = m02 * m21 - m01 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m01 * m20 - m00 * m21
    c20 = m01 * m12 - m02 * m11
    c21 = m02 * m10 - m00 * m12
    c22 = m00 * m11 - m01 * m10
    det = m00 * c00 + m01 * c01 + m02 * c02
    adj = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]
