'''A small pure-Python msgpack decoder for flax checkpoints.

Decodes maps, str, bin, arrays, ints, floats, bool and nil, and flax's
array extension types (flax.serialization): ext 1 is an ndarray stored as
a nested msgpack of (shape, dtype name, C-order bytes); ext 3 (a numpy
scalar) uses the same payload. Other extension types raise.
'''
import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError('truncated msgpack data')
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ext(code, payload):
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype, buf = msgpack_restore(payload)
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == 'bfloat16':
            raise ValueError('bfloat16 arrays are not supported')
        arr = np.frombuffer(bytes(buf), dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr
    raise ValueError(f'unknown msgpack extension type {code}')


def _read(r):
    b = r.unpack('B')
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_read(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return bytes(r.take(b & 0x1f)).decode()
    fixed = {0xc0: None, 0xc2: False, 0xc3: True}
    if b in fixed:
        return fixed[b]
    if b in (0xc4, 0xc5, 0xc6):  # bin 8/16/32
        return bytes(r.take(r.unpack({0xc4: '>B', 0xc5: '>H',
                                      0xc6: '>I'}[b])))
    if b in (0xc7, 0xc8, 0xc9):  # ext 8/16/32
        n = r.unpack({0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}[b])
        code = r.unpack('>b')
        return _ext(code, r.take(n))
    if b in (0xd4, 0xd5, 0xd6, 0xd7, 0xd8):  # fixext 1..16
        code = r.unpack('>b')
        return _ext(code, r.take(1 << (b - 0xd4)))
    scalars = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
               0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
    if b in scalars:
        return r.unpack(scalars[b])
    if b in (0xd9, 0xda, 0xdb):  # str 8/16/32
        n = r.unpack({0xd9: '>B', 0xda: '>H', 0xdb: '>I'}[b])
        return bytes(r.take(n)).decode()
    if b in (0xdc, 0xdd):  # array 16/32
        return [_read(r) for _ in range(r.unpack('>H' if b == 0xdc
                                                 else '>I'))]
    if b in (0xde, 0xdf):  # map 16/32
        return _map(r, r.unpack('>H' if b == 0xde else '>I'))
    raise ValueError(f'unsupported msgpack type byte 0x{b:02x}')


def _map(r, n):
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    return out


def msgpack_restore(data):
    '''Decode one msgpack object from bytes: for a flax checkpoint, the
    nested dict of numpy arrays and Python values that
    flax.serialization.msgpack_restore gives.'''
    r = _Reader(data)
    out = _read(r)
    if r.pos != len(r.data):
        raise ValueError('trailing bytes after the msgpack object')
    return out

