"""An arithmetic-coded JPEG writer for the decoder's tests
(``tests/test_torch_jpeg.py``): no writer at hand makes such files (PIL's
and TF's write Huffman-coded ones only).

The coder is T.81's QM coder (Annex D) with the DCT coefficient models of
F.1.4 (sequential) and G.1.3 (progressive), in libjpeg's jcarith.c
formulation; the pixels go through the JFIF YCbCr transform, box
subsampling, an exact floating-point DCT and the Annex K tables scaled by
quality as jcparam.c scales them. Sequential files (SOF9) have one
interleaved scan, progressive ones (SOF10) libjpeg's simple progression
script; an optional restart interval, and DAC conditioning.

TF decodes these files (its libjpeg-turbo is built with arithmetic
decoding) to pixels as close to the input as a Huffman-coded file of the
same quality, so the coder is right, and the port must decode them as TF
does.
"""
import numpy as np

QE = [0x5a1d, 0x2586, 0x1114, 0x080b, 0x03d8, 0x01da, 0x00e5, 0x006f, 0x0036,
      0x001a, 0x000d, 0x0006, 0x0003, 0x0001, 0x5a7f, 0x3f25, 0x2cf2, 0x207c,
      0x17b9, 0x1182, 0x0cef, 0x09a1, 0x072f, 0x055c, 0x0406, 0x0303, 0x0240,
      0x01b1, 0x0144, 0x00f5, 0x00b7, 0x008a, 0x0068, 0x004e, 0x003b, 0x002c,
      0x5ae1, 0x484c, 0x3a0d, 0x2ef1, 0x261f, 0x1f33, 0x19a8, 0x1518, 0x1177,
      0x0e74, 0x0bfb, 0x09f8, 0x0861, 0x0706, 0x05cd, 0x04de, 0x040f, 0x0363,
      0x02d4, 0x025c, 0x01f8, 0x01a4, 0x0160, 0x0125, 0x00f6, 0x00cb, 0x00ab,
      0x008f, 0x5b12, 0x4d04, 0x412c, 0x37d8, 0x2fe8, 0x293c, 0x2379, 0x1edf,
      0x1aa9, 0x174e, 0x1424, 0x119c, 0x0f6b, 0x0d51, 0x0bb6, 0x0a40, 0x5832,
      0x4d1c, 0x438e, 0x3bdd, 0x34ee, 0x2eae, 0x299a, 0x2516, 0x5570, 0x4ca9,
      0x44d9, 0x3e22, 0x3824, 0x32b4, 0x2e17, 0x56a8, 0x4f46, 0x47e5, 0x41cf,
      0x3c3d, 0x375e, 0x5231, 0x4c0f, 0x4639, 0x415e, 0x5627, 0x50e7, 0x4b85,
      0x5597, 0x504f, 0x5a10, 0x5522, 0x59eb, 0x5a1d]
NMPS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 13, 15, 16, 17, 18, 19,
        20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 9,
        37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53,
        54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 32, 65, 66, 67, 68, 69, 70,
        71, 72, 73, 74, 75, 76, 77, 78, 79, 48, 81, 82, 83, 84, 85, 86, 87,
        71, 89, 90, 91, 92, 93, 94, 86, 96, 97, 98, 99, 100, 93, 102, 103,
        104, 99, 106, 107, 103, 109, 107, 111, 109, 111, 113]
NLPS = [1, 14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9, 10, 12, 15, 36, 38, 39,
        40, 42, 43, 45, 46, 48, 49, 51, 52, 54, 56, 57, 59, 60, 62, 63, 32,
        33, 37, 64, 65, 67, 68, 69, 70, 72, 73, 74, 75, 77, 78, 79, 48, 50,
        50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 61, 61, 65, 80, 81, 82, 83,
        84, 86, 87, 87, 72, 72, 74, 74, 75, 77, 77, 80, 88, 89, 90, 91, 92,
        93, 86, 88, 95, 96, 97, 99, 99, 93, 95, 101, 102, 103, 104, 99, 105,
        106, 107, 103, 105, 108, 109, 110, 111, 110, 112, 112, 113]
SWITCH = {0, 14, 36, 64, 80, 88, 95, 105, 110, 112}
NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
           26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
           56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
           38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


class QMEncoder:
    """jcarith.c's arith_encode and finish_pass."""

    def __init__(self, out: bytearray):
        self.out = out
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = (
            0, 0x10000, 0, 0, 11, -1)

    def _zeros(self):
        self.out.extend(b"\0" * self.zc)
        self.zc = 0

    def _byte(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def encode(self, stats, i, val):
        sv = stats[i]
        idx = sv & 0x7F
        qe = QE[idx]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ (NLPS[idx] | (0x80 if idx in SWITCH
                                                   else 0))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ NMPS[idx]
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out.extend(b"\xff\x00" * self.sc)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer)
            if self.sc:
                self._zeros()
                self.out.extend(b"\xff\x00" * self.sc)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)


LUM = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
                92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
                100, 103, 99])
CHR = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
               + [99] * 32)
_D = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u
                                                             * np.pi / 16)
                for x in range(8)] for u in range(8)])


def _qtable(base, quality):
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _coefficients(plane, qt, bw, bh):
    """(bh, bw, 64) quantized coefficients, natural order, of a plane
    edge-padded to bw x bh blocks."""
    h, w = plane.shape
    p = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128.0
    coef = np.einsum("ux,byxz,vz->byuv", _D, blocks, _D).reshape(bh, bw, 64)
    return np.round(coef / qt).astype(np.int64)


class _Scan:
    def __init__(self, enc, comps, ss, se, ah, al, progressive, dac):
        self.enc, self.comps = enc, comps
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.progressive = progressive
        self.dc_l, self.dc_u, self.ac_k = dac
        self.fixed = [113]
        self.reset_stats()

    def reset_stats(self):
        self.dc_stats, self.ac_stats = {}, {}
        for c in self.comps:
            if not self.progressive or (self.ss == 0 and self.ah == 0):
                self.dc_stats[c["td"]] = [0] * 64
                c["last"] = 0
                c["ctx"] = 0
            if not self.progressive or self.ss:
                self.ac_stats[c["ta"]] = [0] * 256

    def dc_diff(self, c, v):
        e = self.enc
        st, base = self.dc_stats[c["td"]], c["ctx"]
        if v == 0:
            e.encode(st, base, 0)
            c["ctx"] = 0
            return
        e.encode(st, base, 1)
        if v > 0:
            e.encode(st, base + 1, 0)
            i = base + 2
            c["ctx"] = 4
        else:
            v = -v
            e.encode(st, base + 1, 1)
            i = base + 3
            c["ctx"] = 8
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v
            i = 20
            v2 >>= 1
            while v2:
                e.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        e.encode(st, i, 0)
        if m < ((1 << self.dc_l) >> 1):
            c["ctx"] = 0
        elif m > ((1 << self.dc_u) >> 1):
            c["ctx"] += 8
        i += 14
        m >>= 1
        while m:
            e.encode(st, i, 1 if m & v else 0)
            m >>= 1

    def ac_value(self, c, st, i, k, v):
        """Sign already coded; v = |value| >= 1; i at the coefficient's
        bins (3(k-1))."""
        e = self.enc
        i += 2
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v >> 1
            if v2:
                e.encode(st, i, 1)
                m <<= 1
                i = 189 if k <= self.ac_k else 217
                v2 >>= 1
                while v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        e.encode(st, i, 0)
        i += 14
        m >>= 1
        while m:
            e.encode(st, i, 1 if m & v else 0)
            m >>= 1

    def sequential(self, c, blk):
        self.dc_diff(c, int(blk[0]) - c["last"])
        c["last"] = int(blk[0])
        st = self.ac_stats[c["ta"]]
        nat = [int(blk[NATURAL[k]]) for k in range(64)]
        ke = 63
        while ke > 0 and nat[ke] == 0:
            ke -= 1
        k = 1
        while k <= ke:
            i = 3 * (k - 1)
            self.enc.encode(st, i, 0)
            while nat[k] == 0:
                self.enc.encode(st, i + 1, 0)
                i += 3
                k += 1
            self.enc.encode(st, i + 1, 1)
            v = nat[k]
            self.enc.encode(self.fixed, 0, 0 if v > 0 else 1)
            self.ac_value(c, st, i, k, abs(v))
            k += 1
        if k <= 63:
            self.enc.encode(st, 3 * (k - 1), 1)

    def dc_first(self, c, blk):
        m = int(blk[0]) >> self.al
        self.dc_diff(c, m - c["last"])
        c["last"] = m

    def dc_refine(self, c, blk):
        self.enc.encode(self.fixed, 0, (int(blk[0]) >> self.al) & 1)

    def ac_first(self, c, blk):
        st = self.ac_stats[c["ta"]]
        nat = [int(blk[NATURAL[k]]) for k in range(64)]
        sh = lambda k: abs(nat[k]) >> self.al  # noqa: E731
        ke = self.se
        while ke > 0 and sh(ke) == 0:
            ke -= 1
        k = self.ss
        while k <= ke:
            i = 3 * (k - 1)
            self.enc.encode(st, i, 0)
            while sh(k) == 0:
                self.enc.encode(st, i + 1, 0)
                i += 3
                k += 1
            self.enc.encode(st, i + 1, 1)
            self.enc.encode(self.fixed, 0, 0 if nat[k] > 0 else 1)
            self.ac_value(c, st, i, k, sh(k))
            k += 1
        if k <= self.se:
            self.enc.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, c, blk):
        st = self.ac_stats[c["ta"]]
        nat = [int(blk[NATURAL[k]]) for k in range(64)]
        sh = lambda k, b: abs(nat[k]) >> b  # noqa: E731
        ke = self.se
        while ke > 0 and sh(ke, self.al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and sh(kex, self.ah) == 0:
            kex -= 1
        k = self.ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                self.enc.encode(st, i, 0)
            while True:
                v = sh(k, self.al)
                if v:
                    if v >> 1:
                        self.enc.encode(st, i + 2, v & 1)
                    else:
                        self.enc.encode(st, i + 1, 1)
                        self.enc.encode(self.fixed, 0,
                                        0 if nat[k] > 0 else 1)
                    break
                self.enc.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= self.se:
            self.enc.encode(st, 3 * (k - 1), 1)


SIMPLE_PROGRESSION_3 = [  # jcparam.c jpeg_simple_progression, YCbCr
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0)]
SIMPLE_PROGRESSION_1 = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                        ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                        ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def write_arithmetic(px, quality=75, subsampling="4:2:0",
                     progressive=False, restart=0, dac=None):
    """An arithmetic-coded JPEG of (h, w, 3) or (h, w) uint8 pixels:
    SOF9 (sequential, one interleaved scan) or SOF10 (progressive, libjpeg's
    simple progression), JFIF YCbCr or grayscale, an optional restart
    interval and DAC conditioning ``(L, U, K)`` for every table."""
    px = np.asarray(px)
    gray = px.ndim == 2
    h, w = px.shape[:2]
    if gray:
        planes = [px.astype(np.float64)]
        factors = [(1, 1)]
    else:
        r, g, b = (px[..., i].astype(np.float64) for i in range(3))
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
        hy, vy = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}[
            subsampling]
        planes = [y]
        for ch in (cb, cr):
            ph, pw = -(-h // vy) * vy, -(-w // hy) * hy
            p = np.pad(ch, ((0, ph - h), (0, pw - w)), mode="edge")
            planes.append(p.reshape(ph // vy, vy, pw // hy, hy).mean((1, 3)))
        factors = [(hy, vy), (1, 1), (1, 1)]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    qts = [_qtable(LUM, quality), _qtable(CHR, quality)]
    comps = []
    for i, (plane, (hf, vf)) in enumerate(zip(planes, factors)):
        dw, dh = -(-w * hf // hmax), -(-h * vf // vmax)
        tq = 0 if i == 0 else 1
        qt = qts[tq]
        coef = _coefficients(np.clip(plane[:dh, :dw], 0, 255), qt,
                             mcux * hf, mcuy * vf)
        comps.append({"id": i + 1, "h": hf, "v": vf, "tq": tq, "td": tq,
                      "ta": tq, "coef": coef, "wib": -(-dw // 8),
                      "hib": -(-dh // 8)})
    out = bytearray(b"\xff\xd8")
    out += b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    for t in range(1 if gray else 2):
        out += b"\xff\xdb\x00\x43" + bytes([t])
        out += bytes(int(qts[t][NATURAL[k]]) for k in range(64))
    out += bytes([0xFF, 0xCA if progressive else 0xC9])
    out += (8 + 3 * len(comps)).to_bytes(2, "big") + bytes([8])
    out += h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([len(comps)])
    for c in comps:
        out += bytes([c["id"], (c["h"] << 4) | c["v"], c["tq"]])
    dl, du, ak = dac if dac is not None else (0, 1, 5)
    if dac is not None:
        tabs = range(1 if gray else 2)
        body = b"".join(bytes([t, (du << 4) | dl]) + bytes([0x10 | t, ak])
                        for t in tabs)
        out += b"\xff\xcc" + (2 + len(body)).to_bytes(2, "big") + body
    if restart:
        out += b"\xff\xdd\x00\x04" + restart.to_bytes(2, "big")
    if progressive:
        script = SIMPLE_PROGRESSION_1 if gray else SIMPLE_PROGRESSION_3
    else:
        script = [(tuple(range(len(comps))), 0, 63, 0, 0)]
    for idx, ss, se, ah, al in script:
        sc = [comps[i] for i in idx]
        out += b"\xff\xda" + (6 + 2 * len(sc)).to_bytes(2, "big")
        out += bytes([len(sc)])
        for c in sc:
            out += bytes([c["id"], (c["td"] << 4) | c["ta"]])
        out += bytes([ss, se, (ah << 4) | al])
        enc = QMEncoder(out)
        scan = _Scan(enc, sc, ss, se, ah, al, progressive, (dl, du, ak))
        if not progressive:
            fn = scan.sequential
        elif ss == 0:
            fn = scan.dc_first if ah == 0 else scan.dc_refine
        else:
            fn = scan.ac_first if ah == 0 else scan.ac_refine
        if len(sc) == 1:
            c = sc[0]
            units = [[(c, c["coef"][by, bx])] for by in range(c["hib"])
                     for bx in range(c["wib"])]
        else:
            units = [[(c, c["coef"][my * c["v"] + yy, mx * c["h"] + xx])
                      for c in sc for yy in range(c["v"])
                      for xx in range(c["h"])]
                     for my in range(mcuy) for mx in range(mcux)]
        for n, unit in enumerate(units):
            if restart and n and n % restart == 0:
                enc.finish()
                out += bytes([0xFF, 0xD0 + ((n // restart - 1) & 7)])
                enc.reset()
                scan.reset_stats()
            for c, blk in unit:
                fn(c, blk)
        enc.finish()
    out += b"\xff\xd9"
    return bytes(out)
