"""PDF standard security handler (empty-user-password decryption).

A large fraction of real-world PDFs are encrypted with an empty user
password; the reference opens them transparently through pdfium
(reference: rapid_doc/utils/pdf_image_tools.py:26-48 never special-cases
them). Implements the standard handler per PDF 32000-1 §7.6: RC4 (V1/V2),
AES-128 (V4/AESV2) and AES-256 (V5/R5/R6), owner-password bypass not
attempted.

AES-CBC *decryption* parallelizes across blocks (each block decrypt is
independent; the chaining XOR uses ciphertext), so the AES inverse cipher
here is numpy-vectorized over all blocks — megabytes/second in pure
python+numpy, fast enough for stream payloads.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np

PAD = bytes(
    [
        0x28, 0xBF, 0x4E, 0x5E, 0x4E, 0x75, 0x8A, 0x41, 0x64, 0x00, 0x4E,
        0x56, 0xFF, 0xFA, 0x01, 0x08, 0x2E, 0x2E, 0x00, 0xB6, 0xD0, 0x68,
        0x3E, 0x80, 0x2F, 0x0C, 0xA9, 0xFE, 0x64, 0x53, 0x69, 0x7A,
    ]
)


def rc4(key: bytes, data: bytes) -> bytes:
    S = list(range(256))
    j = 0
    klen = len(key)
    for i in range(256):
        j = (j + S[i] + key[i % klen]) & 0xFF
        S[i], S[j] = S[j], S[i]
    out = bytearray(len(data))
    i = j = 0
    for n, byte in enumerate(data):
        i = (i + 1) & 0xFF
        j = (j + S[i]) & 0xFF
        S[i], S[j] = S[j], S[i]
        out[n] = byte ^ S[(S[i] + S[j]) & 0xFF]
    return bytes(out)


# --------------------------------------------------------------------- AES

_SBOX = np.array(
    [
        0x63, 0x7C, 0x77, 0x7B, 0xF2, 0x6B, 0x6F, 0xC5, 0x30, 0x01, 0x67,
        0x2B, 0xFE, 0xD7, 0xAB, 0x76, 0xCA, 0x82, 0xC9, 0x7D, 0xFA, 0x59,
        0x47, 0xF0, 0xAD, 0xD4, 0xA2, 0xAF, 0x9C, 0xA4, 0x72, 0xC0, 0xB7,
        0xFD, 0x93, 0x26, 0x36, 0x3F, 0xF7, 0xCC, 0x34, 0xA5, 0xE5, 0xF1,
        0x71, 0xD8, 0x31, 0x15, 0x04, 0xC7, 0x23, 0xC3, 0x18, 0x96, 0x05,
        0x9A, 0x07, 0x12, 0x80, 0xE2, 0xEB, 0x27, 0xB2, 0x75, 0x09, 0x83,
        0x2C, 0x1A, 0x1B, 0x6E, 0x5A, 0xA0, 0x52, 0x3B, 0xD6, 0xB3, 0x29,
        0xE3, 0x2F, 0x84, 0x53, 0xD1, 0x00, 0xED, 0x20, 0xFC, 0xB1, 0x5B,
        0x6A, 0xCB, 0xBE, 0x39, 0x4A, 0x4C, 0x58, 0xCF, 0xD0, 0xEF, 0xAA,
        0xFB, 0x43, 0x4D, 0x33, 0x85, 0x45, 0xF9, 0x02, 0x7F, 0x50, 0x3C,
        0x9F, 0xA8, 0x51, 0xA3, 0x40, 0x8F, 0x92, 0x9D, 0x38, 0xF5, 0xBC,
        0xB6, 0xDA, 0x21, 0x10, 0xFF, 0xF3, 0xD2, 0xCD, 0x0C, 0x13, 0xEC,
        0x5F, 0x97, 0x44, 0x17, 0xC4, 0xA7, 0x7E, 0x3D, 0x64, 0x5D, 0x19,
        0x73, 0x60, 0x81, 0x4F, 0xDC, 0x22, 0x2A, 0x90, 0x88, 0x46, 0xEE,
        0xB8, 0x14, 0xDE, 0x5E, 0x0B, 0xDB, 0xE0, 0x32, 0x3A, 0x0A, 0x49,
        0x06, 0x24, 0x5C, 0xC2, 0xD3, 0xAC, 0x62, 0x91, 0x95, 0xE4, 0x79,
        0xE7, 0xC8, 0x37, 0x6D, 0x8D, 0xD5, 0x4E, 0xA9, 0x6C, 0x56, 0xF4,
        0xEA, 0x65, 0x7A, 0xAE, 0x08, 0xBA, 0x78, 0x25, 0x2E, 0x1C, 0xA6,
        0xB4, 0xC6, 0xE8, 0xDD, 0x74, 0x1F, 0x4B, 0xBD, 0x8B, 0x8A, 0x70,
        0x3E, 0xB5, 0x66, 0x48, 0x03, 0xF6, 0x0E, 0x61, 0x35, 0x57, 0xB9,
        0x86, 0xC1, 0x1D, 0x9E, 0xE1, 0xF8, 0x98, 0x11, 0x69, 0xD9, 0x8E,
        0x94, 0x9B, 0x1E, 0x87, 0xE9, 0xCE, 0x55, 0x28, 0xDF, 0x8C, 0xA1,
        0x89, 0x0D, 0xBF, 0xE6, 0x42, 0x68, 0x41, 0x99, 0x2D, 0x0F, 0xB0,
        0x54, 0xBB, 0x16,
    ],
    np.uint8,
)
_INV_SBOX = np.zeros(256, np.uint8)
_INV_SBOX[_SBOX] = np.arange(256, dtype=np.uint8)

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36,
         0x6C, 0xD8, 0xAB, 0x4D]


def _xtime_table() -> dict[int, np.ndarray]:
    """GF(2^8) multiply-by-constant lookup tables."""
    tables = {}
    for c in (2, 3, 9, 11, 13, 14):
        t = np.zeros(256, np.uint8)
        for x in range(256):
            v, a, acc = c, x, 0
            while v:
                if v & 1:
                    acc ^= a
                hi = a & 0x80
                a = ((a << 1) & 0xFF) ^ (0x1B if hi else 0)
                v >>= 1
            t[x] = acc
        tables[c] = t
    return tables


_MUL = _xtime_table()


def _expand_key(key: bytes) -> np.ndarray:
    """-> (rounds+1, 4, 4) round keys, column-major state layout."""
    nk = len(key) // 4
    rounds = {4: 10, 6: 12, 8: 14}[nk]
    words = [list(key[4 * i : 4 * i + 4]) for i in range(nk)]
    for i in range(nk, 4 * (rounds + 1)):
        temp = list(words[i - 1])
        if i % nk == 0:
            temp = temp[1:] + temp[:1]
            temp = [int(_SBOX[b]) for b in temp]
            temp[0] ^= _RCON[i // nk - 1]
        elif nk > 6 and i % nk == 4:
            temp = [int(_SBOX[b]) for b in temp]
        words.append([a ^ b for a, b in zip(words[i - nk], temp)])
    rk = np.asarray(words, np.uint8).reshape(rounds + 1, 4, 4)
    return rk  # [round][word][byte]


_SHIFT = np.array(
    [0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11]
)  # ShiftRows as a flat permutation of the 16-byte block (col-major state)
_INV_SHIFT = np.zeros(16, np.int64)
_INV_SHIFT[_SHIFT] = np.arange(16)


def _mix_columns(s: np.ndarray, inverse: bool) -> np.ndarray:
    """s: (N, 16) blocks laid out column-major (byte i = col i//4, row i%4)."""
    b = s.reshape(-1, 4, 4)  # (N, col, row)
    r0, r1, r2, r3 = b[:, :, 0], b[:, :, 1], b[:, :, 2], b[:, :, 3]
    if inverse:
        m = _MUL
        n0 = m[14][r0] ^ m[11][r1] ^ m[13][r2] ^ m[9][r3]
        n1 = m[9][r0] ^ m[14][r1] ^ m[11][r2] ^ m[13][r3]
        n2 = m[13][r0] ^ m[9][r1] ^ m[14][r2] ^ m[11][r3]
        n3 = m[11][r0] ^ m[13][r1] ^ m[9][r2] ^ m[14][r3]
    else:
        m = _MUL
        n0 = m[2][r0] ^ m[3][r1] ^ r2 ^ r3
        n1 = r0 ^ m[2][r1] ^ m[3][r2] ^ r3
        n2 = r0 ^ r1 ^ m[2][r2] ^ m[3][r3]
        n3 = m[3][r0] ^ r1 ^ r2 ^ m[2][r3]
    return np.stack([n0, n1, n2, n3], axis=2).reshape(-1, 16)


def _aes_decrypt_blocks(key: bytes, blocks: np.ndarray) -> np.ndarray:
    """blocks: (N, 16) uint8 ciphertext -> plaintext (vectorized over N)."""
    rk = _expand_key(key).reshape(-1, 16)
    rounds = len(rk) - 1
    s = blocks ^ rk[rounds]
    for rnd in range(rounds - 1, 0, -1):
        s = s[:, _INV_SHIFT]
        s = _INV_SBOX[s]
        s = s ^ rk[rnd]
        s = _mix_columns(s, inverse=True)
    s = s[:, _INV_SHIFT]
    s = _INV_SBOX[s]
    return s ^ rk[0]


def _aes_encrypt_blocks(key: bytes, blocks: np.ndarray) -> np.ndarray:
    rk = _expand_key(key).reshape(-1, 16)
    rounds = len(rk) - 1
    s = blocks ^ rk[0]
    for rnd in range(1, rounds):
        s = _SBOX[s]
        s = s[:, _SHIFT]
        s = _mix_columns(s, inverse=False)
        s = s ^ rk[rnd]
    s = _SBOX[s]
    s = s[:, _SHIFT]
    return s ^ rk[rounds]


def aes_cbc_decrypt(key: bytes, data: bytes, strip_padding: bool = True) -> bytes:
    """data = IV || ciphertext (PDF convention). Vectorized over blocks."""
    if len(data) < 32 or len(data) % 16:
        return b""
    buf = np.frombuffer(data, np.uint8).reshape(-1, 16)
    iv, ct = buf[:1], buf[1:]
    pt = _aes_decrypt_blocks(key, ct)
    pt = pt ^ np.concatenate([iv, ct[:-1]])
    out = pt.tobytes()
    if strip_padding and out:
        pad = out[-1]
        if 1 <= pad <= 16:
            out = out[:-pad]
    return out


def aes_cbc_encrypt(key: bytes, data: bytes, iv: bytes) -> bytes:
    """IV || CBC ciphertext with PKCS#7 padding (fixture building + R6)."""
    pad = 16 - len(data) % 16
    data = data + bytes([pad]) * pad
    blocks = np.frombuffer(data, np.uint8).reshape(-1, 16).copy()
    prev = np.frombuffer(iv, np.uint8)
    out = [prev]
    for i in range(len(blocks)):
        enc = _aes_encrypt_blocks(key, (blocks[i] ^ prev)[None])[0]
        out.append(enc)
        prev = enc
    return np.concatenate(out).tobytes()


def aes_cbc_encrypt_nopad(key: bytes, data: bytes, iv: bytes = b"\0" * 16) -> bytes:
    """CBC encrypt without padding and without prepending the IV (R6 hash)."""
    blocks = np.frombuffer(data, np.uint8).reshape(-1, 16).copy()
    prev = np.frombuffer(iv, np.uint8)
    out = []
    for i in range(len(blocks)):
        enc = _aes_encrypt_blocks(key, (blocks[i] ^ prev)[None])[0]
        out.append(enc)
        prev = enc
    return np.concatenate(out).tobytes()


def aes_cbc_decrypt_nopad(key: bytes, data: bytes, iv: bytes = b"\0" * 16) -> bytes:
    buf = np.frombuffer(data, np.uint8).reshape(-1, 16)
    pt = _aes_decrypt_blocks(key, buf)
    prev = np.concatenate(
        [np.frombuffer(iv, np.uint8)[None], buf[:-1]], axis=0
    )
    return (pt ^ prev).tobytes()


# ------------------------------------------------------- standard handler


def _r6_hash(password: bytes, salt: bytes, udata: bytes = b"") -> bytes:
    """ISO 32000-2 / Adobe R6 iterated hash (Algorithm 2.B)."""
    k = hashlib.sha256(password + salt + udata).digest()
    i = 0
    while True:
        k1 = (password + k + udata) * 64
        e = aes_cbc_encrypt_nopad(k[:16], k1, k[16:32])
        mod = sum(e[:16]) % 3
        if mod == 0:
            k = hashlib.sha256(e).digest()
        elif mod == 1:
            k = hashlib.sha384(e).digest()
        else:
            k = hashlib.sha512(e).digest()
        i += 1
        if i >= 64 and e[-1] <= i - 32:
            return k[:32]


class DecryptionError(Exception):
    pass


class StandardSecurityHandler:
    """Empty-user-password standard security handler."""

    def __init__(self, enc: dict, file_id: bytes):
        self.v = int(enc.get("V", 0))
        self.r = int(enc.get("R", 2))
        self.o = _as_bytes(enc.get("O", b""))
        self.u = _as_bytes(enc.get("U", b""))
        self.p = int(enc.get("P", -1)) & 0xFFFFFFFF
        self.length = int(enc.get("Length", 40)) // 8
        self.encrypt_metadata = bool(enc.get("EncryptMetadata", True))
        self.file_id = file_id
        self.cfm = "V2" if self.v <= 2 else None  # RC4 default
        if self.v >= 4:
            cf = enc.get("CF", {}) or {}
            stmf = str(enc.get("StmF", "Identity"))
            std = cf.get("StdCF") or cf.get(stmf) or {}
            self.cfm = str(std.get("CFM", "V2"))
            if "Length" in std:
                ln = int(std["Length"])
                self.length = ln // 8 if ln > 40 else ln
        if self.v == 5:
            self.cfm = "AESV3"
            self.key = self._auth_v5(enc)
        else:
            self.key = self._auth_legacy()

    # -- key derivation ---------------------------------------------------

    def _auth_legacy(self) -> bytes:
        n = self.length if self.v > 1 else 5
        h = hashlib.md5()
        h.update(PAD)
        h.update(self.o[:32])
        h.update(struct.pack("<I", self.p))
        h.update(self.file_id)
        if self.r >= 4 and not self.encrypt_metadata:
            h.update(b"\xff\xff\xff\xff")
        key = h.digest()
        if self.r >= 3:
            for _ in range(50):
                key = hashlib.md5(key[:n]).digest()
        key = key[:n]
        if not self._check_user_legacy(key):
            raise DecryptionError(
                "PDF requires a non-empty user password"
            )
        return key

    def _check_user_legacy(self, key: bytes) -> bool:
        if self.r == 2:
            return rc4(key, PAD) == self.u[:32]
        digest = hashlib.md5(PAD + self.file_id).digest()
        x = rc4(key, digest)
        for i in range(1, 20):
            x = rc4(bytes(b ^ i for b in key), x)
        return x == self.u[:16]

    def _auth_v5(self, enc: dict) -> bytes:
        if len(self.u) < 48:
            raise DecryptionError("malformed /U for V5 encryption")
        vsalt, ksalt = self.u[32:40], self.u[40:48]
        if self.r == 5:
            ok = hashlib.sha256(b"" + vsalt).digest() == self.u[:32]
            ikey = hashlib.sha256(b"" + ksalt).digest()
        else:  # R6
            ok = _r6_hash(b"", vsalt) == self.u[:32]
            ikey = _r6_hash(b"", ksalt)
        if not ok:
            raise DecryptionError("PDF requires a non-empty user password")
        ue = _as_bytes(enc.get("UE", b""))
        if len(ue) < 32:
            raise DecryptionError("missing /UE")
        return aes_cbc_decrypt_nopad(ikey, ue[:32])

    # -- per-object decryption ---------------------------------------------

    def _object_key(self, num: int, gen: int) -> bytes:
        if self.v == 5:
            return self.key
        h = hashlib.md5()
        h.update(self.key)
        h.update(struct.pack("<I", num)[:3])
        h.update(struct.pack("<I", gen)[:2])
        if self.cfm == "AESV2":
            h.update(b"sAlT")
        return h.digest()[: min(len(self.key) + 5, 16)]

    def decrypt(self, data: bytes, num: int, gen: int) -> bytes:
        if not data:
            return data
        key = self._object_key(num, gen)
        if self.cfm in ("AESV2", "AESV3"):
            return aes_cbc_decrypt(key, data)
        return rc4(key, data)

    def encrypt(self, data: bytes, num: int, gen: int) -> bytes:
        """Symmetric RC4 path + AES with a fixed IV (fixture building)."""
        key = self._object_key(num, gen)
        if self.cfm in ("AESV2", "AESV3"):
            iv = hashlib.md5(struct.pack("<II", num, gen)).digest()
            return aes_cbc_encrypt(key, data, iv)
        return rc4(key, data)


def _as_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode("latin-1")
    return bytes(v or b"")
