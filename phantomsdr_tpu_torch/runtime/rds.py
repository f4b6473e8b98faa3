"""Host-side RDS protocol decoder (baseband -> PI/PS/RadioText).

The DSP half runs on device (ops/rds.py: pilot-locked 57 kHz downmix
to complex baseband at a few kS/s).  This module is the protocol half
the reference runs in the browser (jsdsp/redsea.js, the redsea WASM
build): BPSK carrier-phase resolution, biphase symbol timing, the
differential decode, 26-bit block synchronization against the RDS
offset words, and group parsing into the fields the UI shows.  It is
bit twiddling on a ~2.4 kS/s stream per listener -- host work by
design, posted to the encode pool like the codecs.

Layering (IEC 62106):
- data 1187.5 bps, differentially encoded, biphase (Manchester)
  symbol-coded at 2375 sym/s,
- blocks of 26 bits = 16 data + 10 check, check = CRC (g(x) = x^10 +
  x^8 + x^7 + x^5 + x^4 + x^3 + 1) XOR a per-position offset word
  (A, B, C, C', D) -- the receiver's syndrome of a clean block equals
  the offset word itself, which is both the error check and the block
  synchronization marker,
- groups of 4 blocks; group types 0A/0B carry the 8-char Programme
  Service name 2 chars at a time, 2A/2B carry 64/32-char RadioText.
"""

from __future__ import annotations

import math

import numpy as np

# g(x) of the RDS (26,16) shortened cyclic code, degree 10
_POLY = 0x5B9
# offset words, in block order; block 2 is C for version-A groups and
# C' for version-B groups
OFFSET_A = 0x0FC
OFFSET_B = 0x198
OFFSET_C = 0x168
OFFSET_CP = 0x350
OFFSET_D = 0x1B4
_BLOCK_OFFSETS = (OFFSET_A, OFFSET_B, OFFSET_C, OFFSET_D)
_OFFSET_TO_BLOCK = {OFFSET_A: 0, OFFSET_B: 1, OFFSET_C: 2, OFFSET_CP: 2,
                    OFFSET_D: 3}

SYMBOL_RATE = 2375.0   # biphase symbols/s (2x the 1187.5 bps bit rate)


def syndrome(word26: int) -> int:
    """Remainder of a 26-bit received block modulo g(x).  For an
    error-free block this equals the position's offset word."""
    reg = word26
    for i in range(25, 9, -1):
        if (reg >> i) & 1:
            reg ^= _POLY << (i - 10)
    return reg & 0x3FF


def crc10(data16: int) -> int:
    """Check bits for a 16-bit information word (before offset XOR)."""
    return syndrome((data16 & 0xFFFF) << 10)


def encode_block(data16: int, offset: int) -> int:
    """data + offset word -> 26-bit block (test/synthesis helper)."""
    return ((data16 & 0xFFFF) << 10) | (crc10(data16) ^ offset)


class RDSBitstream:
    """Complex baseband at fs -> differential-decoded data bits.

    Stages, all streaming-continuous across feed() calls:
    - squaring carrier estimator: the BPSK constellation collapses
      under z^2, so 0.5*arg(leaky sum of z^2) is the residual carrier
      phase (the 57 kHz subcarrier may ride in phase OR in quadrature
      with the pilot's third harmonic; the device mix leaves that
      constant unknown).  The pi ambiguity is absorbed by the
      differential decode,
    - Gardner timing recovery at 2375 sym/s over the derotated real
      part (first-order loop; ppm-scale clock offsets between station
      and SDR appear as a tiny steady-state bias),
    - biphase pairing: symbol pairs (b, -b) make one bit; the pairing
      parity is picked (and re-picked) by comparing in-pair vs
      cross-pair transition strength,
    - differential decode (bit = symbol sign change).
    """

    def __init__(self, fs: float, gardner_gain: float = 0.05,
                 carrier_tau_s: float = 0.5):
        self.fs = float(fs)
        self.sps = self.fs / SYMBOL_RATE
        if self.sps < 2.0:
            raise ValueError(f"baseband rate {fs} < 2 samples/symbol")
        self.gain = gardner_gain
        self.tau = carrier_tau_s
        self.c2 = 0.0 + 0.0j
        self.phi = 0.0
        self.buf = np.zeros(0, np.float32)
        self.t = self.sps  # fractional read position (needs t-sps/2 >= 0)
        self.prev_sym = 0.0
        # biphase pairing state
        self._pending: float | None = None
        self._last_second = 0.0
        self.q_keep = 0.0
        self.q_flip = 0.0
        self._prev_bit = 0

    # ------------------------------------------------------------------
    def feed(self, z: np.ndarray) -> list[int]:
        """Consume complex baseband samples; return decoded data bits."""
        if z.size == 0:
            return []
        # ---- carrier: leaky z^2 accumulator, continuous phase track
        rho = math.exp(-z.size / (self.tau * self.fs))
        self.c2 = self.c2 * rho + complex(np.sum(z * z))
        if abs(self.c2) > 0:
            phi2 = 0.5 * math.atan2(self.c2.imag, self.c2.real)
            # phi is defined mod pi; step to the representative closest
            # to the current track so derotation stays continuous
            d = (phi2 - self.phi + math.pi / 2) % math.pi - math.pi / 2
            self.phi += d
        y = (z * np.exp(-1j * self.phi)).real.astype(np.float32)
        rms = float(np.sqrt(np.mean(y * y)))
        if rms > 0:
            y = y / rms  # scale-free Gardner gain
        self.buf = np.concatenate([self.buf, y])

        # ---- Gardner symbol recovery
        syms: list[float] = []
        buf = self.buf
        n = buf.size
        t = self.t
        sps = self.sps
        half = sps / 2.0
        prev = self.prev_sym
        gain = self.gain
        while t + 1.0 < n:
            i = int(t)
            fr = t - i
            s = buf[i] * (1.0 - fr) + buf[i + 1] * fr
            tm = t - half
            j = int(tm)
            fm = tm - j
            mid = buf[j] * (1.0 - fm) + buf[j + 1] * fm
            e = (s - prev) * mid
            # late sampling -> positive e on a rising transition; pull
            # the next strobe earlier (clamped to 1/8 symbol per step)
            t += sps - max(-sps / 8, min(sps / 8, gain * e))
            prev = s
            syms.append(float(s))
        # drop consumed samples, keep enough history for t - sps/2
        keep_from = max(0, int(t - sps) )
        self.buf = buf[keep_from:]
        self.t = t - keep_from
        self.prev_sym = prev

        # ---- biphase pairing + differential decode
        bits: list[int] = []
        for s in syms:
            if self._pending is None:
                self._pending = s
                continue
            first, second = self._pending, s
            self._pending = None
            self.q_keep = 0.995 * self.q_keep + abs(first - second)
            self.q_flip = 0.995 * self.q_flip + abs(self._last_second
                                                    - first)
            self._last_second = second
            if self.q_flip > 1.3 * self.q_keep and self.q_flip > 8.0:
                # cross-pair transitions dominate: we are pairing across
                # bit boundaries; shift parity by one symbol.  For
                # ~balanced data the CORRECT parity converges to
                # q_flip/q_keep = 0.5 (in-pair |s - (-s)| = 2, cross-pair
                # averages 1) and the WRONG parity to 2.0 from below --
                # the threshold must sit strictly inside (0.5, 2.0); a
                # `> 2.0` test is unreachable and left the decoder stuck
                # at the wrong parity for the ~50% of activations whose
                # first strobe lands mid-bit
                self._pending = second
                self.q_keep, self.q_flip = self.q_flip, self.q_keep
                continue
            b = 1 if (first - second) > 0 else 0
            bits.append(b ^ self._prev_bit)  # differential decode
            self._prev_bit = b
        return bits


class RDSGroupDecoder:
    """Data bits -> block sync -> groups -> PI/PS/RadioText/PTY."""

    RESYNC_AFTER = 8  # consecutive bad blocks before dropping sync

    def __init__(self):
        self.reg = 0
        self.nbits = 0          # bits since last block boundary (synced)
        self.total_bits = 0
        self.synced = False
        self.expect = 0         # next block index 0..3
        self.bad = 0
        self.blocks: list[int | None] = [None] * 4
        # acquisition: recent (bit_position, block_index) syndrome hits
        self._cands: list[tuple[int, int]] = []
        # decoded state
        self.pi: int | None = None
        self.pty: int | None = None
        self.ps = [" "] * 8
        self.rt = [" "] * 64
        self.rt_ab: int | None = None
        self.groups = 0
        self.block_errors = 0
        self.changed = False

    # ------------------------------------------------------------------
    def push_bits(self, bits: list[int]):
        for b in bits:
            self._push(b)

    def _push(self, bit: int):
        self.reg = ((self.reg << 1) | (bit & 1)) & ((1 << 26) - 1)
        self.total_bits += 1
        if not self.synced:
            self._acquire()
            return
        self.nbits += 1
        if self.nbits < 26:
            return
        self.nbits = 0
        s = syndrome(self.reg)
        data = (self.reg >> 10) & 0xFFFF
        want = _BLOCK_OFFSETS[self.expect]
        ok = s == want or (self.expect == 2 and s == OFFSET_CP)
        if ok:
            self.bad = 0
            # (the group version comes from block B's version bit in
            # _parse_group; the C/C' offset distinction only gates sync)
            self.blocks[self.expect] = data
            if self.expect == 3:
                self._parse_group()
        else:
            self.bad += 1
            self.block_errors += 1
            self.blocks[self.expect] = None
            if self.bad >= self.RESYNC_AFTER:
                self.synced = False
                self._cands.clear()
        if self.expect == 3:
            self.blocks = [None] * 4
        self.expect = (self.expect + 1) % 4

    def _acquire(self):
        """Sync = two syndrome hits exactly 26 bits apart with
        consecutive block indices (a single hit is noise 5/1024 of the
        time)."""
        s = syndrome(self.reg)
        idx = _OFFSET_TO_BLOCK.get(s)
        if idx is None:
            return
        n = self.total_bits
        for (pn, pidx) in self._cands:
            if n - pn == 26 and (pidx + 1) % 4 == idx:
                self.synced = True
                self.bad = 0
                self.nbits = 0
                self.blocks = [None] * 4
                self.blocks[idx] = (self.reg >> 10) & 0xFFFF
                if idx == 3:
                    self.blocks = [None] * 4
                self.expect = (idx + 1) % 4
                self._cands.clear()
                return
        self._cands.append((n, idx))
        self._cands = [(pn, pi) for (pn, pi) in self._cands if n - pn <= 26]

    # ------------------------------------------------------------------
    def _parse_group(self):
        a, b, c, d = self.blocks
        if a is None or b is None:
            return
        self.groups += 1
        if self.pi != a:
            self.pi = a
            self.changed = True
        gt = (b >> 12) & 0xF
        version = (b >> 11) & 1
        pty = (b >> 5) & 0x1F
        if self.pty != pty:
            self.pty = pty
            self.changed = True
        if gt == 0 and d is not None:
            seg = b & 0x3
            for k, ch in enumerate(((d >> 8) & 0xFF, d & 0xFF)):
                cc = chr(ch) if 32 <= ch < 127 else " "
                if self.ps[2 * seg + k] != cc:
                    self.ps[2 * seg + k] = cc
                    self.changed = True
        elif gt == 2:
            ab = (b >> 4) & 1
            if self.rt_ab is not None and ab != self.rt_ab:
                self.rt = [" "] * 64  # text A/B flag: clear display
                self.changed = True
            self.rt_ab = ab
            if version == 0 and c is not None and d is not None:
                seg = b & 0xF
                chars = ((c >> 8) & 0xFF, c & 0xFF,
                         (d >> 8) & 0xFF, d & 0xFF)
                base = 4 * seg
            elif version == 1 and d is not None:
                seg = b & 0xF
                chars = ((d >> 8) & 0xFF, d & 0xFF)
                base = 2 * seg
            else:
                return
            for k, ch in enumerate(chars):
                if ch == 0x0D:
                    # carriage return TERMINATES RadioText (IEC 62106):
                    # blank the rest of the buffer, not just this cell --
                    # stations shortening their message without toggling
                    # the A/B flag never retransmit the tail segments,
                    # which would otherwise display stale text forever
                    for j in range(base + k, 64):
                        if self.rt[j] != " ":
                            self.rt[j] = " "
                            self.changed = True
                    break
                cc = chr(ch) if 32 <= ch < 127 else " "
                if self.rt[base + k] != cc:
                    self.rt[base + k] = cc
                    self.changed = True

    # ------------------------------------------------------------------
    def status(self) -> dict:
        return {
            "pi": f"{self.pi:04X}" if self.pi is not None else None,
            "pty": self.pty,
            "ps": "".join(self.ps).rstrip(),
            "rt": "".join(self.rt).rstrip(),
            "groups": self.groups,
            "block_errors": self.block_errors,
            "synced": self.synced,
        }


class RDSDecoder:
    """Per-listener decoder: int8 device baseband in, status dict out
    when a displayed field changed."""

    def __init__(self, fs_baseband: float):
        self.bits = RDSBitstream(fs_baseband)
        self.group = RDSGroupDecoder()

    def feed(self, iq_int8: np.ndarray) -> dict | None:
        """iq_int8: [2, T] int8 (device layout, ops/rds.py).  Returns
        the updated status when PI/PS/RT/PTY changed, else None."""
        z = (iq_int8[0].astype(np.float32)
             + 1j * iq_int8[1].astype(np.float32))
        self.group.push_bits(self.bits.feed(z))
        if self.group.changed:
            self.group.changed = False
            return self.group.status()
        return None
