// GROMACS XTC trajectory codec (XDR "3dfcoord" compressed coordinates).
//
// Native data-loader component: the reference reads XTC through
// mdtraj's C extensions (enspara/util/load.py); this is a standalone
// clean-room implementation of the public XTC bitstream format
// (big-endian XDR framing + the magic-int quantized delta coding used
// by GROMACS). The encoder emits full run-length groups (water-swap
// reordering, adaptive small-delta quantum seeded from the median
// inter-atom displacement), producing lossless streams comparable to
// or smaller than GROMACS' own output.
//
// Exposed C ABI (ctypes):
//   xtc_scan(path, &n_frames, &n_atoms)       -> 0 on success
//   xtc_read(path, natoms, max_frames, xyz, box, time, step) -> n read
//   xtc_write(path, natoms, n_frames, xyz, box, time, step, precision)

#include <algorithm>
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <vector>

namespace {

const int MAGIC = 1995;
const int FIRSTIDX = 9;

const int magicints[] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290,
    1625, 2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384,
    20642, 26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072,
    165140, 208063, 262144, 330280, 416127, 524287, 660561, 832255,
    1048576, 1321122, 1664510, 2097152, 2642245, 3329021, 4194304,
    5284491, 6658042, 8388607, 10568983, 13316085, 16777216};
const int LASTIDX = (int)(sizeof(magicints) / sizeof(int)) - 1;
const int N_MAGICINTS = (int)(sizeof(magicints) / sizeof(int));

// ---------------- big-endian scalar IO ----------------

bool read_be_i32(FILE* f, int32_t* v) {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    *v = (int32_t)(((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) |
                   ((uint32_t)b[2] << 8) | (uint32_t)b[3]);
    return true;
}

bool read_be_f32(FILE* f, float* v) {
    int32_t iv;
    if (!read_be_i32(f, &iv)) return false;
    std::memcpy(v, &iv, 4);
    return true;
}

void write_be_i32(FILE* f, int32_t v) {
    unsigned char b[4] = {(unsigned char)((uint32_t)v >> 24),
                          (unsigned char)((uint32_t)v >> 16),
                          (unsigned char)((uint32_t)v >> 8),
                          (unsigned char)v};
    fwrite(b, 1, 4, f);
}

void write_be_f32(FILE* f, float v) {
    int32_t iv;
    std::memcpy(&iv, &v, 4);
    write_be_i32(f, iv);
}

// ---------------- bit stream ----------------

struct BitReader {
    const unsigned char* data;
    size_t nbytes;
    size_t cnt = 0;
    unsigned int lastbits = 0;
    unsigned int lastbyte = 0;

    int bits(int num_of_bits) {
        int mask = (1 << num_of_bits) - 1;
        unsigned int num = 0;
        while (num_of_bits >= 8) {
            lastbyte = (lastbyte << 8) | (cnt < nbytes ? data[cnt] : 0);
            cnt++;
            num |= (lastbyte >> lastbits) << (num_of_bits - 8);
            num_of_bits -= 8;
        }
        if (num_of_bits > 0) {
            if (lastbits < (unsigned)num_of_bits) {
                lastbits += 8;
                lastbyte = (lastbyte << 8) | (cnt < nbytes ? data[cnt] : 0);
                cnt++;
            }
            lastbits -= num_of_bits;
            num |= (lastbyte >> lastbits) & ((1u << num_of_bits) - 1);
        }
        return (int)(num & mask);
    }

    void ints(int num_of_ints, int num_of_bits, const unsigned int sizes[],
              int nums[]) {
        int bytes[32];
        int num_of_bytes = 0;
        bytes[1] = bytes[2] = bytes[3] = 0;
        while (num_of_bits > 8) {
            bytes[num_of_bytes++] = bits(8);
            num_of_bits -= 8;
        }
        if (num_of_bits > 0) bytes[num_of_bytes++] = bits(num_of_bits);
        for (int i = num_of_ints - 1; i > 0; i--) {
            unsigned int num = 0;
            for (int j = num_of_bytes - 1; j >= 0; j--) {
                num = (num << 8) | (unsigned int)bytes[j];
                unsigned int p = num / sizes[i];
                bytes[j] = (int)p;
                num = num - p * sizes[i];
            }
            nums[i] = (int)num;
        }
        nums[0] = bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) |
                  (bytes[3] << 24);
    }
};

struct BitWriter {
    std::vector<unsigned char> out;
    unsigned int lastbits = 0;
    unsigned int lastbyte = 0;

    void bits(int value, int num_of_bits) {
        // chunk whole bytes first: with up to 7 pending bits, shifting
        // the 32-bit accumulator by >24 bits would discard high bits
        // (review finding; GROMACS sendbits chunks the same way)
        unsigned int v = (unsigned int)value &
                         ((num_of_bits < 32) ? ((1u << num_of_bits) - 1)
                                             : 0xffffffffu);
        while (num_of_bits >= 8) {
            num_of_bits -= 8;
            lastbyte = (lastbyte << 8) | ((v >> num_of_bits) & 0xff);
            lastbits += 8;
            while (lastbits >= 8) {
                lastbits -= 8;
                out.push_back(
                    (unsigned char)((lastbyte >> lastbits) & 0xff));
            }
        }
        if (num_of_bits > 0) {
            lastbyte = (lastbyte << num_of_bits)
                       | (v & ((1u << num_of_bits) - 1));
            lastbits += num_of_bits;
            while (lastbits >= 8) {
                lastbits -= 8;
                out.push_back(
                    (unsigned char)((lastbyte >> lastbits) & 0xff));
            }
        }
    }

    void ints(int num_of_ints, int num_of_bits, const unsigned int sizes[],
              const int nums[]) {
        // little-endian multiprecision accumulate, mirroring the
        // decoder's successive-division: v = ((nums[0]*sizes[1]) +
        // nums[1])*sizes[2] + nums[2] ...
        unsigned char bytes[32] = {0};
        int num_of_bytes = 1;
        bytes[0] = 0;
        // seed with nums[0]
        {
            unsigned int carry = (unsigned int)nums[0];
            int j = 0;
            while (carry) {
                bytes[j++] = (unsigned char)(carry & 0xff);
                carry >>= 8;
            }
            if (j > num_of_bytes) num_of_bytes = j;
        }
        for (int i = 1; i < num_of_ints; i++) {
            // bytes = bytes * sizes[i] + nums[i]
            unsigned int carry = (unsigned int)nums[i];
            for (int j = 0; j < num_of_bytes; j++) {
                unsigned int t = (unsigned int)bytes[j] * sizes[i] + carry;
                bytes[j] = (unsigned char)(t & 0xff);
                carry = t >> 8;
            }
            while (carry) {
                bytes[num_of_bytes++] = (unsigned char)(carry & 0xff);
                carry >>= 8;
            }
        }
        // emit little-endian bytes; remaining (<8) bits from next byte
        int bits_left = num_of_bits;
        int byte_idx = 0;
        while (bits_left > 8) {
            this->bits(bytes[byte_idx++], 8);
            bits_left -= 8;
        }
        if (bits_left > 0) this->bits(bytes[byte_idx], bits_left);
    }

    void flush() {
        if (lastbits > 0) {
            out.push_back(
                (unsigned char)((lastbyte << (8 - lastbits)) & 0xff));
            lastbits = 0;
        }
    }
};

int sizeofint(unsigned int size) {
    int num_of_bits = 0;
    unsigned int num = 1;
    while (size >= num && num_of_bits < 32) {
        num_of_bits++;
        num <<= 1;
    }
    return num_of_bits;
}

int sizeofints(int num_of_ints, const unsigned int sizes[]) {
    unsigned char bytes[32];
    int num_of_bytes = 1;
    bytes[0] = 1;
    int num_of_bits = 0;
    for (int i = 0; i < num_of_ints; i++) {
        unsigned int tmp = 0;
        int bytecnt = 0;
        for (; bytecnt < num_of_bytes; bytecnt++) {
            tmp += (unsigned int)bytes[bytecnt] * sizes[i];
            bytes[bytecnt] = (unsigned char)(tmp & 0xff);
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = (unsigned char)(tmp & 0xff);
            tmp >>= 8;
        }
        num_of_bytes = bytecnt;
    }
    int num = 1;
    num_of_bytes--;
    while ((int)bytes[num_of_bytes] >= num) {
        num_of_bits++;
        num *= 2;
    }
    return num_of_bits + num_of_bytes * 8;
}

// Skip a frame body after natoms has been read from the header.
// Returns false on IO error / truncation.
bool skip_coords(FILE* f) {
    int32_t lsize;
    if (!read_be_i32(f, &lsize)) return false;
    if (lsize <= 9) {
        return fseek(f, 12L * lsize, SEEK_CUR) == 0;
    }
    // precision + minint[3] + maxint[3] + smallidx
    if (fseek(f, 4L + 24L + 4L, SEEK_CUR) != 0) return false;
    int32_t nbytes;
    if (!read_be_i32(f, &nbytes)) return false;
    long padded = (nbytes + 3L) & ~3L;
    return fseek(f, padded, SEEK_CUR) == 0;
}

bool read_frame_header(FILE* f, int32_t* natoms, int32_t* step,
                       float* time, float box[9]) {
    int32_t magic;
    if (!read_be_i32(f, &magic)) return false;
    if (magic != MAGIC) return false;
    if (!read_be_i32(f, natoms)) return false;
    if (!read_be_i32(f, step)) return false;
    if (!read_be_f32(f, time)) return false;
    for (int i = 0; i < 9; i++) {
        if (!read_be_f32(f, &box[i])) return false;
    }
    return true;
}

// Decode one frame's coordinates into xyz (natoms*3 floats).
bool decode_coords(FILE* f, int natoms, float* xyz) {
    int32_t lsize;
    if (!read_be_i32(f, &lsize)) return false;
    if (lsize != natoms) return false;

    if (lsize <= 9) {
        for (int i = 0; i < lsize * 3; i++) {
            if (!read_be_f32(f, &xyz[i])) return false;
        }
        return true;
    }

    float precision;
    int32_t minint[3], maxint[3], smallidx;
    if (!read_be_f32(f, &precision)) return false;
    for (int i = 0; i < 3; i++) {
        if (!read_be_i32(f, &minint[i])) return false;
    }
    for (int i = 0; i < 3; i++) {
        if (!read_be_i32(f, &maxint[i])) return false;
    }
    if (!read_be_i32(f, &smallidx)) return false;
    // smallidx comes straight from the file: reject out-of-table or
    // zero-size values before they index magicints[] or divide by a
    // zero sizesmall (review finding: OOB read / SIGFPE on corrupt
    // input)
    if (smallidx < FIRSTIDX || smallidx >= N_MAGICINTS - 1)
        return false;

    unsigned int sizeint[3], sizesmall[3];
    int bitsizeint[3] = {0, 0, 0};
    int bitsize;
    sizeint[0] = (unsigned int)(maxint[0] - minint[0]) + 1;
    sizeint[1] = (unsigned int)(maxint[1] - minint[1]) + 1;
    sizeint[2] = (unsigned int)(maxint[2] - minint[2]) + 1;

    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        bitsizeint[0] = sizeofint(sizeint[0]);
        bitsizeint[1] = sizeofint(sizeint[1]);
        bitsizeint[2] = sizeofint(sizeint[2]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(3, sizeint);
    }

    int tmpidx = smallidx - 1;
    tmpidx = (FIRSTIDX > tmpidx) ? FIRSTIDX : tmpidx;
    int smaller = magicints[tmpidx] / 2;
    int smallnum = magicints[smallidx] / 2;
    sizesmall[0] = sizesmall[1] = sizesmall[2] =
        (unsigned int)magicints[smallidx];

    int32_t nbytes;
    if (!read_be_i32(f, &nbytes)) return false;
    long padded = (nbytes + 3L) & ~3L;
    std::vector<unsigned char> blob(padded);
    if (fread(blob.data(), 1, padded, f) != (size_t)padded) return false;

    BitReader br{blob.data(), (size_t)nbytes};
    float inv_precision = 1.0f / precision;

    int thiscoord[3], prevcoord[3] = {0, 0, 0};
    int i = 0;
    float* lfp = xyz;
    int run = 0;

    while (i < lsize) {
        if (bitsize == 0) {
            thiscoord[0] = br.bits(bitsizeint[0]);
            thiscoord[1] = br.bits(bitsizeint[1]);
            thiscoord[2] = br.bits(bitsizeint[2]);
        } else {
            br.ints(3, bitsize, sizeint, thiscoord);
        }
        i++;
        thiscoord[0] += minint[0];
        thiscoord[1] += minint[1];
        thiscoord[2] += minint[2];
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];

        // NOTE: the flag bit signals that the run-length CHANGED; when
        // it is 0 the previous run-length repeats, so `run` must
        // persist across atoms.
        int flag = br.bits(1);
        int is_smaller = 0;
        if (flag == 1) {
            run = br.bits(5);
            is_smaller = run % 3;
            run -= is_smaller;
            is_smaller--;
        }
        if (run > 0) {
            for (int k = 0; k < run; k += 3) {
                if (i >= lsize)
                    // a run crossing the final atom would write past
                    // the caller's exactly-sized buffer (review
                    // finding: heap corruption on crafted input)
                    return false;
                br.ints(3, smallidx, sizesmall, thiscoord);
                i++;
                thiscoord[0] += prevcoord[0] - smallnum;
                thiscoord[1] += prevcoord[1] - smallnum;
                thiscoord[2] += prevcoord[2] - smallnum;
                if (k == 0) {
                    // swap first-in-run with the large coordinate:
                    // improves compression of water molecules
                    int t;
                    t = thiscoord[0]; thiscoord[0] = prevcoord[0];
                    prevcoord[0] = t;
                    t = thiscoord[1]; thiscoord[1] = prevcoord[1];
                    prevcoord[1] = t;
                    t = thiscoord[2]; thiscoord[2] = prevcoord[2];
                    prevcoord[2] = t;
                    *lfp++ = prevcoord[0] * inv_precision;
                    *lfp++ = prevcoord[1] * inv_precision;
                    *lfp++ = prevcoord[2] * inv_precision;
                } else {
                    prevcoord[0] = thiscoord[0];
                    prevcoord[1] = thiscoord[1];
                    prevcoord[2] = thiscoord[2];
                }
                *lfp++ = thiscoord[0] * inv_precision;
                *lfp++ = thiscoord[1] * inv_precision;
                *lfp++ = thiscoord[2] * inv_precision;
            }
        } else {
            *lfp++ = thiscoord[0] * inv_precision;
            *lfp++ = thiscoord[1] * inv_precision;
            *lfp++ = thiscoord[2] * inv_precision;
        }
        smallidx += is_smaller;
        if (smallidx < 0 || smallidx >= N_MAGICINTS - 1) return false;
        if (is_smaller < 0) {
            smallnum = smaller;
            if (smallidx > FIRSTIDX) {
                smaller = magicints[smallidx - 1] / 2;
            } else {
                smaller = 0;
            }
        } else if (is_smaller > 0) {
            smaller = smallnum;
            smallnum = magicints[smallidx] / 2;
        }
        sizesmall[0] = sizesmall[1] = sizesmall[2] =
            (unsigned int)magicints[smallidx];
        if (sizesmall[0] == 0) return false;
    }
    return true;
}

}  // namespace

extern "C" {

long xtc_scan(const char* path, long* n_frames, long* n_atoms) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    long frames = 0;
    int32_t natoms = 0, step;
    float time, box[9];
    while (true) {
        int32_t na;
        if (!read_frame_header(f, &na, &step, &time, box)) break;
        if (frames == 0) natoms = na;
        if (!skip_coords(f)) break;
        frames++;
    }
    fclose(f);
    *n_frames = frames;
    *n_atoms = natoms;
    return 0;
}

long xtc_read(const char* path, long natoms, long max_frames, float* xyz,
              float* box_out, float* time_out, int* step_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    long frame = 0;
    int32_t na, step;
    float time, box[9];
    while (frame < max_frames) {
        if (!read_frame_header(f, &na, &step, &time, box)) break;
        if (na != natoms) break;
        if (!decode_coords(f, (int)natoms, xyz + frame * natoms * 3)) {
            break;
        }
        std::memcpy(box_out + frame * 9, box, 9 * sizeof(float));
        time_out[frame] = time;
        step_out[frame] = step;
        frame++;
    }
    fclose(f);
    return frame;
}

long xtc_write(const char* path, long natoms, long n_frames,
               const float* xyz, const float* box, const float* time,
               const int* step, float precision) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;

    for (long fr = 0; fr < n_frames; fr++) {
        const float* fx = xyz + fr * natoms * 3;
        write_be_i32(f, MAGIC);
        write_be_i32(f, (int32_t)natoms);
        write_be_i32(f, step ? step[fr] : (int32_t)fr);
        write_be_f32(f, time ? time[fr] : (float)fr);
        for (int i = 0; i < 9; i++) {
            write_be_f32(f, box ? box[fr * 9 + i] : (i % 4 == 0 ? 1.f : 0.f));
        }
        write_be_i32(f, (int32_t)natoms);

        if (natoms <= 9) {
            for (long i = 0; i < natoms * 3; i++) write_be_f32(f, fx[i]);
            continue;
        }

        write_be_f32(f, precision);

        std::vector<int> ip(natoms * 3);
        int minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
        int maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
        for (long a = 0; a < natoms; a++) {
            for (int d = 0; d < 3; d++) {
                float v = fx[a * 3 + d] * precision;
                int iv = (int)lrintf(v);
                ip[a * 3 + d] = iv;
                if (iv < minint[d]) minint[d] = iv;
                if (iv > maxint[d]) maxint[d] = iv;
            }
        }
        for (int d = 0; d < 3; d++) write_be_i32(f, minint[d]);
        for (int d = 0; d < 3; d++) write_be_i32(f, maxint[d]);

        unsigned int sizeint[3];
        int bitsizeint[3] = {0, 0, 0};
        int bitsize;
        for (int d = 0; d < 3; d++) {
            sizeint[d] = (unsigned int)(maxint[d] - minint[d]) + 1;
        }
        if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
            for (int d = 0; d < 3; d++) {
                bitsizeint[d] = sizeofint(sizeint[d]);
            }
            bitsize = 0;
        } else {
            bitsize = sizeofints(3, sizeint);
        }

        // choose the small-delta quantum from the median consecutive
        // displacement (the adaptive analogue of gromacs' mindiff scan)
        std::vector<int> pair_diffs;
        pair_diffs.reserve(natoms - 1);
        for (long a = 1; a < natoms; a++) {
            int m = 0;
            for (int d = 0; d < 3; d++) {
                int dd = std::abs(ip[a * 3 + d] - ip[(a - 1) * 3 + d]);
                if (dd > m) m = dd;
            }
            pair_diffs.push_back(m);
        }
        std::nth_element(pair_diffs.begin(),
                         pair_diffs.begin() + pair_diffs.size() / 2,
                         pair_diffs.end());
        const int med = pair_diffs[pair_diffs.size() / 2];
        int smallidx = FIRSTIDX;
        while (smallidx < LASTIDX - 1
               && magicints[smallidx] / 2 <= 2 * med) {
            smallidx++;
        }
        const int smallnum = magicints[smallidx] / 2;
        const unsigned int ss = (unsigned int)magicints[smallidx];
        const unsigned int sizesmall[3] = {ss, ss, ss};

        write_be_i32(f, smallidx);

        // a small delta must land in [0, sizesmall) after +smallnum
        auto fits_small = [&](const int* a, const int* b) {
            for (int d = 0; d < 3; d++) {
                int diff = a[d] - b[d];
                if (diff < -smallnum
                    || diff >= (int)ss - smallnum) return false;
            }
            return true;
        };

        BitWriter bw;
        int tmp3[3];
        long i = 0;
        int prevrun = -1;
        while (i < natoms) {
            // water trick: if the next atom is near this one, emit the
            // next atom as the 'big' coordinate and this one as the
            // first small delta (mirrors the decoder's k==0 swap).
            // BOTH directions must fit: the emitted first delta is the
            // NEGATION of (next - cur), and the small range
            // [-smallnum, ss - smallnum) is asymmetric — a diff of
            // exactly -smallnum negates to +smallnum, which overflows
            // the field and silently corrupts the whole run.
            bool is_small = (i + 1 < natoms)
                && fits_small(&ip[(i + 1) * 3], &ip[i * 3])
                && fits_small(&ip[i * 3], &ip[(i + 1) * 3]);
            if (is_small) {
                for (int d = 0; d < 3; d++) {
                    std::swap(ip[i * 3 + d], ip[(i + 1) * 3 + d]);
                }
            }

            for (int d = 0; d < 3; d++) {
                tmp3[d] = ip[i * 3 + d] - minint[d];
            }
            if (bitsize == 0) {
                bw.bits(tmp3[0], bitsizeint[0]);
                bw.bits(tmp3[1], bitsizeint[1]);
                bw.bits(tmp3[2], bitsizeint[2]);
            } else {
                bw.ints(3, bitsize, sizeint, tmp3);
            }
            const int* prev = &ip[i * 3];
            i++;

            int run = 0;
            int smalls[24 * 3];
            while (is_small && run < 8 * 3) {
                for (int d = 0; d < 3; d++) {
                    smalls[run + d] = ip[i * 3 + d] - prev[d] + smallnum;
                }
                prev = &ip[i * 3];
                run += 3;
                i++;
                is_small = (i < natoms)
                    && fits_small(&ip[i * 3], prev);
            }

            if (run != prevrun) {
                prevrun = run;
                bw.bits(1, 1);
                bw.bits(run + 1, 5);  // is_smaller = 0 encoding
            } else {
                bw.bits(0, 1);
            }
            for (int k = 0; k < run; k += 3) {
                bw.ints(3, smallidx, sizesmall, &smalls[k]);
            }
        }
        bw.flush();

        int32_t nbytes = (int32_t)bw.out.size();
        write_be_i32(f, nbytes);
        long padded = (nbytes + 3L) & ~3L;
        bw.out.resize(padded, 0);
        if (fwrite(bw.out.data(), 1, padded, f) != (size_t)padded) {
            fclose(f);
            return -1;
        }
    }
    // buffered writes latch errors (e.g. ENOSPC) on the stream:
    // surface them instead of reporting a truncated file as success
    // (review finding)
    if (fflush(f) != 0 || ferror(f)) {
        fclose(f);
        return -1;
    }
    fclose(f);
    return n_frames;
}

}  // extern "C"
