'''A small pure-Python msgpack codec for flax checkpoints.

Decodes maps, str, bin, arrays, ints, floats, bool and nil, and flax's
array extension types (flax.serialization): ext 1 is an ndarray stored as
a nested msgpack of (shape, dtype name, C-order bytes); ext 3 (a numpy
scalar) uses the same payload. Other extension types raise.

`msgpack_serialize` writes the same format: dicts with str keys, lists and
tuples, str, bytes, bool, None, ints, floats, and numpy arrays and scalars
as ext 1, so that flax.serialization.msgpack_restore reads what it writes.
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


def _pack_uint(n):
    for limit, code, fmt in ((0x80, None, None), (1 << 8, 0xcc, '>B'),
                             (1 << 16, 0xcd, '>H'), (1 << 32, 0xce, '>I'),
                             (1 << 64, 0xcf, '>Q')):
        if n < limit:
            return bytes([n]) if code is None else \
                bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f'integer {n} does not fit msgpack')


def _pack_int(n):
    if n >= 0:
        return _pack_uint(n)
    if n >= -32:
        return struct.pack('b', n)
    for lo, code, fmt in ((-(1 << 7), 0xd0, '>b'), (-(1 << 15), 0xd1, '>h'),
                          (-(1 << 31), 0xd2, '>i'), (-(1 << 63), 0xd3, '>q')):
        if n >= lo:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f'integer {n} does not fit msgpack')


def _pack_len(n, fix_base, fix_max, codes):
    '''Header of a str / bin / array / map of n entries.'''
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f'length {n} does not fit msgpack')


def _pack_ext(code, payload):
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _pack_len(n, None, 0, ((0xc7, '>B'), (0xc8, '>H'),
                                      (0xc9, '>I')))
    return head + struct.pack('>b', code) + payload


def _pack(obj, out):
    if obj is None:
        out.append(b'\xc0')
    elif obj is True or obj is False:
        out.append(b'\xc3' if obj else b'\xc2')
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.kind not in 'biuf':
            raise TypeError(f'cannot serialize an array of {arr.dtype}')
        payload = msgpack_serialize([list(arr.shape), arr.dtype.name,
                                     np.ascontiguousarray(arr).tobytes()])
        out.append(_pack_ext(_EXT_NDARRAY, payload))
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b'\xcb' + struct.pack('>d', obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        out.append(_pack_len(len(raw), 0xa0, 31, ((0xd9, '>B'), (0xda, '>H'),
                                                  (0xdb, '>I'))) + raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(_pack_len(len(raw), None, 0, ((0xc4, '>B'), (0xc5, '>H'),
                                                 (0xc6, '>I'))) + raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), 0x90, 15, ((0xdc, '>H'),
                                                  (0xdd, '>I'))))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_pack_len(len(obj), 0x80, 15, ((0xde, '>H'),
                                                  (0xdf, '>I'))))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f'map keys must be str, got {key!r}')
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f'cannot serialize {type(obj).__name__}')


def msgpack_serialize(obj):
    '''Encode `obj` (see the module docstring for the types) as msgpack
    bytes in flax.serialization's format.'''
    out = []
    _pack(obj, out)
    return b''.join(out)
