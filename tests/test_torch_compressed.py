"""PyTorch port: bit-packed and frame-of-reference columns, the packed
exchange wire, packed predicates and zone maps, against the JAX
package.

Counterpart of ``tests/test_compressed.py`` (``TestPackBits``,
``TestPackedEncodings``, ``TestRelationalPackedKeys``,
``TestShuffleCompress``, ``TestPackedPredicates``, ``TestZoneMaps``,
``TestZoneMapMorselSkip``).  The same seeded host data goes through both
packages: lanes are compared lane for lane (every width, the straddling
ones included), masks, row sets and zone stats exactly, CRCs and
``compressed_bytes_saved`` to the byte, and the packed exchanges and
pruned streams deliver the reference's arrays shard for shard.
"""

import dataclasses
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.columnar import encoded as JE
from spark_rapids_jni_tpu.relational import AggSpec as JAggSpec
from spark_rapids_jni_tpu.relational import group_by as jgroup_by
from spark_rapids_jni_tpu.relational import hash_join as jhash_join

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch.columnar import encoded as E
from spark_rapids_jni_tpu_torch.columnar.column import Column, ColumnBatch
from spark_rapids_jni_tpu_torch.relational import AggSpec, group_by, \
    hash_join

from torch_parity import assert_encoded_equal, port_col, to_port, u32
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

P8 = 8
_CMP_OPS = ("<", "<=", "==", "!=", ">=", ">")
_NP_OPS = {"<": operator.lt, "<=": operator.le, "==": operator.eq,
           "!=": operator.ne, ">=": operator.ge, ">": operator.gt}


@pytest.fixture(autouse=True)
def _reset():
    yield
    jconfig.reset()
    tconfig.reset()


def jcol(vals, kind=JT.INT64, valid=None):
    vals = np.asarray(vals)
    v = np.ones(len(vals), bool) if valid is None else np.asarray(valid)
    return JColumn(jnp.asarray(vals), jnp.asarray(v), kind)


def jcol_i64(vals, valid=None):
    return jcol(np.asarray(vals, np.int64), JT.INT64, valid)


def tcol_i64(vals, valid=None):
    return port_col(jcol_i64(vals, valid))


def rows_of(col, n=None) -> list:
    col = E.materialize_column(col)
    out = E._plain_pylist(col)
    return out if n is None else out[:n]


def jrows_of(col, n=None) -> list:
    out = JE.materialize_column(col).to_pylist()
    return out if n is None else out[:n]


def same_rows(jres, jn, tres, tn, name):
    assert int(jn) == int(tn), name
    n = int(jn)
    for c in jres.names:
        assert jrows_of(jres[c], n) == rows_of(tres[c], n), f"{name}/{c}"


# ---------------------------------------------------------------------------
# lane-level pack/unpack
# ---------------------------------------------------------------------------

class TestPackBits:
    @pytest.mark.parametrize("width", list(range(1, 33)))
    def test_round_trip_every_width(self, width):
        rng = np.random.default_rng(width)
        # 97 rows: a partial last lane, and words straddle lanes at every
        # width that does not divide 32 (12, 20, 24 and 28 among them)
        n = 97
        hi = (1 << width) - 1
        words = rng.integers(0, hi + 1 if width < 32 else 1 << 32, n,
                             dtype=np.uint64).astype(np.uint32)
        lanes = E.pack_bits(torch.from_numpy(words.astype(np.int64)), width)
        assert lanes.dtype == torch.int32
        assert lanes.shape[0] == max(1, (n * width + 31) // 32)
        want = np.asarray(JE.pack_bits(jnp.asarray(words), width))
        np.testing.assert_array_equal(u32(lanes), want)
        got = E.unpack_bits(lanes, width, n).numpy()
        np.testing.assert_array_equal(got, words.astype(np.int64))

    def test_full_range_u32_values(self):
        words = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF],
                         np.uint32)
        lanes = E.pack_bits(torch.from_numpy(words.astype(np.int64)), 32)
        np.testing.assert_array_equal(u32(lanes), words)
        np.testing.assert_array_equal(E.unpack_bits(lanes, 32, 5).numpy(),
                                      words.astype(np.int64))

    def test_reference_lanes_unpack_in_the_port(self):
        rng = np.random.default_rng(77)
        for width in (3, 12, 20, 24, 28, 31):
            words = rng.integers(0, 1 << width, 300, dtype=np.uint64) \
                .astype(np.uint32)
            lanes = np.asarray(JE.pack_bits(jnp.asarray(words), width))
            got = E.unpack_bits(torch.from_numpy(lanes.view(np.int32)),
                                width, 300).numpy()
            np.testing.assert_array_equal(got, words.astype(np.int64))

    def test_empty_and_bad_width(self):
        lanes = E.pack_bits(torch.zeros((0,), dtype=torch.int64), 5)
        assert lanes.shape == (1,)
        assert E.unpack_bits(lanes, 5, 0).shape == (0,)
        with pytest.raises(ValueError, match="width"):
            E.pack_bits(torch.zeros((4,), dtype=torch.int64), 0)
        with pytest.raises(ValueError, match="width"):
            E.unpack_bits(torch.zeros((4,), dtype=torch.int32), 33, 4)

    def test_rows_variant_packs_per_partition(self):
        rng = np.random.default_rng(9)
        words = rng.integers(0, 1 << 11, (4, 50), dtype=np.uint64) \
            .astype(np.uint32)
        lanes = E.pack_bits_rows(torch.from_numpy(words.astype(np.int64)),
                                 11)
        want = np.asarray(JE.pack_bits_rows(jnp.asarray(words), 11))
        np.testing.assert_array_equal(u32(lanes), want)
        np.testing.assert_array_equal(
            E.unpack_bits_rows(lanes, 11, 50).numpy(),
            words.astype(np.int64))


# ---------------------------------------------------------------------------
# packed column encodings
# ---------------------------------------------------------------------------

class TestPackedEncodings:
    def test_bitpacked_negatives_and_nulls(self):
        rng = np.random.default_rng(3)
        vals = rng.integers(-500, 40, 257)
        valid = rng.random(257) > 0.2
        jc = jcol_i64(vals, valid)
        je, te = JE.encode_bitpacked(jc), E.encode_bitpacked(port_col(jc))
        assert isinstance(te, E.BitPackedColumn) and E.is_encoded(te)
        assert_encoded_equal(je, te, "bitpacked")
        assert te.zone.crc == je.zone.crc
        dec = te.decode()
        np.testing.assert_array_equal(dec.data.numpy()[valid], vals[valid])
        assert rows_of(te) == jc.to_pylist()

    def test_for_clustered_wide_range_packs_narrow(self):
        rng = np.random.default_rng(5)
        base = np.repeat(np.arange(8, dtype=np.int64) * (1 << 28), 128)
        vals = base + rng.integers(0, 1 << 6, base.shape[0])
        jc = jcol_i64(vals)
        je, te = JE.encode_for(jc, block=128), E.encode_for(port_col(jc),
                                                            block=128)
        assert isinstance(te, E.FrameOfReferenceColumn)
        assert te.num_blocks == 8 and te.width <= 7
        assert_encoded_equal(je, te, "for")
        assert E.encode_bitpacked(port_col(jc)).width > te.width
        np.testing.assert_array_equal(te.values64().numpy(), vals)
        assert te.zone.crc == je.zone.crc

    def test_wide_range_falls_back_to_plain(self):
        c = tcol_i64([0, 1 << 40])
        assert E.encode_bitpacked(c) is c
        assert isinstance(E.encode_for(tcol_i64([0, 1 << 40]), block=1024),
                          Column)
        assert E.choose_pack_width(0, 1 << 40) is None

    def test_gather_stays_packed_and_matches_take(self):
        rng = np.random.default_rng(7)
        vals = rng.integers(-10, 90, 200)
        jc = jcol_i64(vals, rng.random(200) > 0.1)
        je, te = JE.encode_bitpacked(jc), E.encode_bitpacked(port_col(jc))
        idx = rng.integers(0, 200, 64)
        jo = JE.gather_bitpacked(je, jnp.asarray(idx))
        to = E.gather_bitpacked(te, torch.from_numpy(idx))
        assert isinstance(to, E.BitPackedColumn) and to.zone is None
        assert_encoded_equal(jo, to, "gather")
        from spark_rapids_jni_tpu_torch.relational.gather import \
            gather_column

        via = gather_column(te, torch.from_numpy(idx))
        assert isinstance(via, E.BitPackedColumn)
        assert rows_of(via) == jrows_of(jo)

    def test_choose_pack_width_buckets(self):
        for lo, hi in ((0, 1), (0, 3), (-50, 50), (0, 1000),
                       (0, (1 << 32) - 1), (0, 1 << 32), (5, 4), (7, 7),
                       (-(1 << 20), 1 << 20), (0, 1 << 27)):
            assert E.choose_pack_width(lo, hi) == \
                JE.choose_pack_width(lo, hi), (lo, hi)
        assert E.choose_pack_width(0, 1000) == 12


# ---------------------------------------------------------------------------
# relational operators on packed keys
# ---------------------------------------------------------------------------

class TestRelationalPackedKeys:
    @pytest.mark.parametrize("how", ("inner", "left", "full", "anti"))
    def test_join_parity_bitpacked_keys(self, how):
        rng = np.random.default_rng(11)
        lk, rk = rng.integers(0, 40, 150), rng.integers(20, 60, 50)
        left = JBatch({"k": JE.encode_bitpacked(jcol_i64(lk)),
                       "lv": jcol(rng.integers(0, 99, 150).astype(np.int32),
                                  JT.INT32)})
        right = JBatch({"k": JE.encode_for(jcol_i64(rk), block=16),
                        "rv": jcol(rng.integers(0, 99, 50).astype(np.int32),
                                   JT.INT32)})
        jr, jn = jhash_join(left, right, ["k"], ["k"], how, capacity=2048)
        for engine in ("kernel", "sort"):
            tr, tn = hash_join(to_port(left), to_port(right), ["k"], ["k"],
                               how, capacity=2048, engine=engine)
            same_rows(jr, jn, tr, tn, f"join/{how}/{engine}")

    @pytest.mark.parametrize("engine", ("sort", "kernel"))
    def test_groupby_parity_packed_keys(self, engine):
        rng = np.random.default_rng(13)
        n = 300
        jb = JBatch({
            "k": JE.encode_bitpacked(jcol_i64(rng.integers(-8, 8, n),
                                              rng.random(n) > 0.1)),
            "v": jcol(rng.integers(-100, 100, n).astype(np.int32),
                      JT.INT32)})
        specs = (("count", None, "c"), ("sum", "v", "s"), ("min", "v", "mn"),
                 ("max", "v", "mx"))
        jr, jn = jgroup_by(jb, ["k"], [JAggSpec(*a) for a in specs])
        tr, tn = group_by(to_port(jb), ["k"], [AggSpec(*a) for a in specs],
                          engine=engine)
        assert isinstance(tr["k"], E.BitPackedColumn)  # keys stay packed
        same_rows(jr, jn, tr, tn, f"gb/{engine}")


# ---------------------------------------------------------------------------
# the compressed wire
# ---------------------------------------------------------------------------

def _mixed(n, seed):
    rng = np.random.default_rng(seed)
    return JBatch({
        "k": jcol_i64(rng.integers(0, 1000, n)),
        "q": jcol(rng.integers(-50, 50, n).astype(np.int32), JT.INT32),
        "flag": jcol(rng.integers(0, 2, n).astype(bool), JT.BOOLEAN),
        "price": jcol(rng.standard_normal(n).astype(np.float32),
                      JT.FLOAT32)})


def _services():
    from spark_rapids_jni_tpu.parallel import data_mesh
    from spark_rapids_jni_tpu.shuffle import ShuffleRegistry as JReg
    from spark_rapids_jni_tpu.shuffle import ShuffleService as JSvc

    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.shuffle import (ShuffleRegistry,
                                                    ShuffleService)

    jm = data_mesh(P8)
    tm = ShardMesh(P8, device="cpu")
    return jm, JSvc(jm, registry=JReg()), tm, ShuffleService(
        tm, registry=ShuffleRegistry())


def assert_same_exchange(jres, tres):
    """Delivered arrays bit-identical (encoded columns buffer for
    buffer), and the accounting equal."""
    np.testing.assert_array_equal(tres.occupancy.numpy(),
                                  np.asarray(jres.occupancy))
    for name in jres.batch.names:
        jc, tc = jres.batch[name], tres.batch[name]
        if JE.is_encoded(jc):
            assert_encoded_equal(jc, tc, name)
            continue
        for part in ("data", "validity"):
            np.testing.assert_array_equal(
                getattr(tc, part).numpy(), np.asarray(getattr(jc, part)),
                err_msg=f"{name}.{part}")
    for f in ("rounds", "capacity", "rows_moved", "bytes_moved",
              "compressed_bytes_saved"):
        assert getattr(tres, f) == getattr(jres, f), f


class TestShuffleCompress:
    def test_exchange_pack_bit_parity_fewer_bytes(self, eight_devices):
        from spark_rapids_jni_tpu.parallel import shard_batch

        jm, jsvc, _tm, tsvc = _services()
        n = P8 * 256
        jb = shard_batch(_mixed(n, 0), jm)
        tb = to_port(_mixed(n, 0))
        out = {}
        for mode in ("off", "pack"):
            jconfig.set("shuffle_compress", mode)
            tconfig.set("shuffle_compress", mode)
            j = jsvc.exchange(jb, key_names=("k",))
            t = tsvc.exchange(tb, key_names=("k",))
            assert_same_exchange(j, t)
            out[mode] = t
        off, pack = out["off"], out["pack"]
        assert pack.rows_moved == off.rows_moved == n
        assert pack.bytes_moved * 1.5 <= off.bytes_moved
        assert off.compressed_bytes_saved == 0
        assert pack.compressed_bytes_saved == \
            off.bytes_moved - pack.bytes_moved > 0
        snap = tsvc.registry.metrics.snapshot()
        assert snap["compressed_bytes_saved"] >= pack.compressed_bytes_saved

    def test_auto_packs_dict_codes_and_bools(self, eight_devices):
        from spark_rapids_jni_tpu.parallel import shard_batch

        jm, jsvc, _tm, tsvc = _services()
        n = P8 * 256
        rng = np.random.default_rng(1)
        db = JBatch({
            "k": jcol_i64(rng.integers(0, 500, n)),
            "s": JE.encode_column(jcol_i64(rng.integers(0, 4, n))),
            "flag": jcol(rng.integers(0, 2, n).astype(bool), JT.BOOLEAN)})
        res = {}
        for mode in ("off", "auto"):
            jconfig.set("shuffle_compress", mode)
            tconfig.set("shuffle_compress", mode)
            j = jsvc.exchange(shard_batch(db, jm), key_names=("k",))
            t = tsvc.exchange(to_port(db), key_names=("k",))
            assert_same_exchange(j, t)
            res[mode] = t
        assert res["auto"].compressed_bytes_saved > 0
        assert res["auto"].bytes_moved < res["off"].bytes_moved

    def test_plain_auto_keeps_legacy_wire(self, eight_devices):
        _jm, _jsvc, _tm, tsvc = _services()
        tb = to_port(_mixed(P8 * 128, 2))
        tconfig.set("shuffle_compress", "off")
        r_off = tsvc.exchange(tb, key_names=("k",))
        tconfig.set("shuffle_compress", "auto")
        r_auto = tsvc.exchange(tb, key_names=("k",))
        assert r_auto.compressed_bytes_saved == 0
        assert r_auto.bytes_moved == r_off.bytes_moved
        np.testing.assert_array_equal(r_auto.occupancy.numpy(),
                                      r_off.occupancy.numpy())

    def test_stream_pack_parity(self, eight_devices):
        from spark_rapids_jni_tpu.parallel import shard_batch

        jm, jsvc, _tm, tsvc = _services()
        n = P8 * 256
        rng = np.random.default_rng(3)
        k = rng.integers(0, 700, n)
        q = rng.integers(-30, 30, n).astype(np.int32)
        flag = rng.integers(0, 2, n).astype(bool)

        def parts():
            for i in range(4):
                lo, hi = i * n // 4, (i + 1) * n // 4
                yield JBatch({"k": jcol_i64(k[lo:hi]),
                              "q": jcol(q[lo:hi], JT.INT32),
                              "flag": jcol(flag[lo:hi], JT.BOOLEAN)})

        res = {}
        for mode in ("off", "pack"):
            jconfig.set("shuffle_compress", mode)
            tconfig.set("shuffle_compress", mode)
            j = jsvc.exchange_stream((shard_batch(b, jm) for b in parts()),
                                     key_names=("k",))
            t = tsvc.exchange_stream((to_port(b) for b in parts()),
                                     key_names=("k",))
            assert_same_exchange(j, t)
            res[mode] = t
        assert res["pack"].rows_moved == n
        assert res["pack"].compressed_bytes_saved == \
            res["off"].bytes_moved - res["pack"].bytes_moved > 0

    def test_packed_columns_decode_before_crossing(self, eight_devices):
        from spark_rapids_jni_tpu.parallel import shard_batch

        jm, jsvc, _tm, tsvc = _services()
        n = P8 * 64
        rng = np.random.default_rng(4)
        jb = JBatch({"k": jcol_i64(rng.integers(0, 50, n)),
                     "p": JE.encode_bitpacked(jcol_i64(rng.integers(0, 9,
                                                                    n))),
                     "f": JE.encode_for(jcol_i64(np.arange(n)), block=64)})
        for mode in ("auto", "pack"):
            jconfig.set("shuffle_compress", mode)
            tconfig.set("shuffle_compress", mode)
            j = jsvc.exchange(shard_batch(jb, jm), key_names=("k",))
            t = tsvc.exchange(to_port(jb), key_names=("k",))
            assert_same_exchange(j, t)


# ---------------------------------------------------------------------------
# packed predicates
# ---------------------------------------------------------------------------

def _sweep(je, te, literals):
    """Every op and literal: the port's packed mask equals the
    reference's and decode-then-compare, with no port decode."""
    dec = te.decode().data.numpy()
    E.reset_packed_decode_count()
    for op in _CMP_OPS:
        for v in literals:
            got = E.packed_filter_mask(te, op, int(v)).numpy()
            assert got.shape == dec.shape, (op, v)
            np.testing.assert_array_equal(got, _NP_OPS[op](dec, int(v)),
                                          f"{op} {v}")
            want = np.asarray(JE.packed_filter_mask(je, op, int(v)))
            np.testing.assert_array_equal(got, want, f"{op} {v} vs ref")
    assert E.packed_decode_count() == 0


class TestPackedPredicates:
    @pytest.mark.parametrize("width", [1, 2, 3, 5, 8, 12, 13, 16, 20, 21,
                                       24, 27, 28, 31, 32])
    def test_bitpacked_parity_all_widths(self, width):
        rng = np.random.default_rng(width)
        n = 257
        hi = (1 << width) - 1
        vals = rng.integers(0, hi + 1, n).astype(np.int64) - 7
        vals[0], vals[1] = -7, hi - 7
        jc = jcol_i64(vals)
        je, te = JE.encode_bitpacked(jc), E.encode_bitpacked(port_col(jc))
        assert isinstance(te, E.BitPackedColumn) and te.width == width
        _sweep(je, te, sorted({-8, -7, 0, int(vals[n // 2]), hi - 7,
                               hi - 6}))

    @pytest.mark.parametrize("block", [64, 100])
    def test_for_parity_block_boundary_literals(self, block):
        rng = np.random.default_rng(block)
        n = 1000
        nb = -(-n // block)
        base = np.repeat(np.arange(nb, dtype=np.int64) * 10_000, block)[:n]
        vals = base + rng.integers(0, 500, n)
        jc = jcol_i64(vals)
        je, te = JE.encode_for(jc, block=block), \
            E.encode_for(port_col(jc), block=block)
        lits = {int(vals.min()) - 1, int(vals.max()) + 1}
        for b in (0, 1, nb - 1):
            seg = vals[b * block:(b + 1) * block]
            lits.update((int(seg.min()), int(seg.max())))
        _sweep(je, te, sorted(lits))

    def test_all_blocks_excluded_and_none_excluded(self):
        vals = np.arange(512, dtype=np.int64) + 100
        for te in (E.encode_bitpacked(tcol_i64(vals)),
                   E.encode_for(tcol_i64(vals), block=64)):
            E.reset_packed_decode_count()
            assert not E.packed_filter_mask(te, "<", 100).any()
            assert E.packed_filter_mask(te, "<=", 10_000).all()
            assert not E.packed_filter_mask(te, ">", 10_000).any()
            assert E.packed_filter_mask(te, ">=", -5).all()
            assert E.packed_decode_count() == 0

    def test_for_int64_extreme_frames_no_wrap(self):
        big = 1 << 62
        vals = np.concatenate([-big + np.arange(128, dtype=np.int64),
                               big + np.arange(128, dtype=np.int64)])
        jc = jcol_i64(vals)
        je, te = JE.encode_for(jc, block=64), E.encode_for(port_col(jc),
                                                           block=64)
        assert isinstance(te, E.FrameOfReferenceColumn)
        _sweep(je, te, [-big - 1, -big + 5, 0, big + 5, big + 200,
                        -(1 << 63), (1 << 63) - 1])

    def test_null_rows_compare_on_decoded_values(self):
        vals = np.arange(64, dtype=np.int64) + 5
        valid = np.ones(64, bool)
        valid[::7] = False
        jc = jcol_i64(vals, valid)
        for je, te in ((JE.encode_bitpacked(jc),
                        E.encode_bitpacked(port_col(jc))),
                       (JE.encode_for(jc, block=16),
                        E.encode_for(port_col(jc), block=16))):
            _sweep(je, te, [4, 20, 69])

    def test_knob_off_decodes_and_matches(self):
        vals = np.arange(100, dtype=np.int64)
        te = E.encode_bitpacked(tcol_i64(vals))
        tconfig.set("packed_predicates", False)
        E.reset_packed_decode_count()
        got = E.packed_filter_mask(te, "<", 50).numpy()
        assert E.packed_decode_count() == 1
        np.testing.assert_array_equal(got, vals < 50)

    def test_non_int_literal_falls_back(self):
        vals = np.arange(100, dtype=np.int64)
        te = E.encode_for(tcol_i64(vals), block=32)
        E.reset_packed_decode_count()
        got = E.packed_filter_mask(te, "<", 49.5).numpy()
        assert E.packed_decode_count() == 1
        np.testing.assert_array_equal(got, vals < 49.5)

    def test_compile_routes_packed_filters(self):
        from spark_rapids_jni_tpu_torch.plan.compile import _filter_mask

        vals = np.arange(2048, dtype=np.int64) * 3
        for te in (E.encode_bitpacked(tcol_i64(vals)),
                   E.encode_for(tcol_i64(vals), block=256)):
            E.reset_packed_decode_count()
            got = _filter_mask(te, ">=", 3000).numpy()
            assert E.packed_decode_count() == 0
            np.testing.assert_array_equal(got, vals >= 3000)
        te = E.encode_column(tcol_i64(vals % 7))
        np.testing.assert_array_equal(_filter_mask(te, "<", 3).numpy(),
                                      (vals % 7) < 3)

    def test_plan_filter_parity_on_packed_input(self):
        from spark_rapids_jni_tpu import plan as jplan
        from spark_rapids_jni_tpu.plan.ir import Agg as JAgg
        from spark_rapids_jni_tpu.plan.ir import Aggregate as JAggregate
        from spark_rapids_jni_tpu.plan.ir import Filter as JFilter
        from spark_rapids_jni_tpu.plan.ir import Scan as JScan

        from spark_rapids_jni_tpu_torch import plan
        from spark_rapids_jni_tpu_torch.plan.ir import (Agg, Aggregate,
                                                        Filter, Scan)

        rng = np.random.default_rng(5)
        n = 2048
        batch = JBatch({
            "k": jcol(rng.integers(0, 10, n).astype(np.int32), JT.INT32),
            "v": jcol_i64(rng.integers(0, 1000, n)),
            "price": JE.encode_bitpacked(jcol_i64(rng.integers(0, 100,
                                                               n)))})

        def q(A, Ag, F, S):
            return A(F(S("batch"), "price", "<", 50), keys=("k",),
                     aggs=(Ag("sum", "v", "sum_v"),
                           Ag("count", None, "cnt")), domain=10, onehot=True)

        jr, jn = jplan.execute(q(JAggregate, JAgg, JFilter, JScan),
                               {"batch": batch})
        E.reset_packed_decode_count()
        tr, tn = plan.execute(q(Aggregate, Agg, Filter, Scan),
                              {"batch": to_port(batch)})
        assert E.packed_decode_count() == 0
        same_rows(jr, jn, tr, tn, "plan/packed filter")


# ---------------------------------------------------------------------------
# zone maps
# ---------------------------------------------------------------------------

class TestZoneMaps:
    def test_sidecar_stats_exact_with_partial_tail(self):
        rng = np.random.default_rng(11)
        n, block = 1000, 128
        vals = rng.integers(-500, 500, n).astype(np.int64)
        jz = JE.encode_for(jcol_i64(vals), block=block).zone
        zm = E.encode_for(tcol_i64(vals), block=block).zone
        assert zm.rows == n and zm.block == block
        assert zm.num_blocks == -(-n // block)
        np.testing.assert_array_equal(zm.mins, jz.mins)
        np.testing.assert_array_equal(zm.maxs, jz.maxs)
        assert zm.crc == jz.crc
        zm.verify()

    def test_bitpacked_sidecar_tail_and_skip_decision(self):
        n = 1100
        vals = np.arange(n, dtype=np.int64)
        zm = E.encode_bitpacked(tcol_i64(vals)).zone
        jz = JE.encode_bitpacked(jcol_i64(vals)).zone
        assert zm.num_blocks == 2 and zm.rows == n and zm.maxs[1] == n - 1
        assert zm.crc == jz.crc
        for op in _CMP_OPS:
            for v in (-1, 0, n - 1, n, 1 << 70, -(1 << 70)):
                np.testing.assert_array_equal(zm.block_may_match(op, v),
                                              jz.block_may_match(op, v))

    def test_corrupt_sidecar_fails_loud(self):
        enc = E.encode_for(tcol_i64(np.arange(256, dtype=np.int64)),
                           block=64)
        lying = dataclasses.replace(enc.zone,
                                    maxs=enc.zone.maxs ^ np.int64(1))
        with pytest.raises(E.ZoneMapCorruptionError):
            lying.verify()

    def test_carried_reference_sidecar_verifies(self):
        jc = JE.encode_for(jcol_i64(np.arange(512, dtype=np.int64)),
                           block=64, column="x")
        tc = port_col(jc)
        tc.zone.verify()
        assert tc.zone.column == "x" and tc.zone.crc == jc.zone.crc
        with pytest.raises(E.ZoneMapCorruptionError):
            dataclasses.replace(tc.zone, mins=tc.zone.mins - 1).verify()

    def test_encode_batch_tags_sidecar_with_column_name(self):
        tb = ColumnBatch({"x": tcol_i64(np.arange(256)),
                          "y": tcol_i64(np.arange(256))})
        enc = E.encode_batch(tb, bitpack=["x"], frame_of_reference=["y"])
        assert enc["x"].zone.column == "x" and enc["y"].zone.column == "y"
        enc["x"].zone.verify()
        enc["y"].zone.verify()

    def test_tampered_column_tag_fails_crc(self):
        enc = E.encode_for(tcol_i64(np.arange(256, dtype=np.int64)),
                           block=64, column="x")
        with pytest.raises(E.ZoneMapCorruptionError):
            dataclasses.replace(enc.zone, column="y").verify()

    def test_knob_off_encodes_without_sidecar(self):
        tconfig.set("zone_maps", False)
        assert E.encode_for(tcol_i64(np.arange(256, dtype=np.int64)),
                            block=64).zone is None

    def test_gather_drops_sidecar(self):
        from spark_rapids_jni_tpu_torch.relational.gather import \
            gather_column

        enc = E.encode_bitpacked(tcol_i64(np.arange(256, dtype=np.int64)))
        assert enc.zone is not None
        out = gather_column(enc, torch.arange(256))
        assert out.zone is None


class TestZoneMapMorselSkip:
    def _setup(self, thresh_q=0.01):
        from spark_rapids_jni_tpu.parallel import data_mesh, shard_batch

        from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh

        n = 8192
        rng = np.random.default_rng(7)
        vals = np.sort(rng.integers(0, 1 << 20, n)).astype(np.int64)
        keys = rng.integers(0, 64, n).astype(np.int64)
        jb = JBatch({"k": jcol_i64(keys), "x": jcol_i64(vals)})
        jm = data_mesh(P8)
        thresh = int(np.quantile(vals, thresh_q))
        return (jm, shard_batch(jb, jm), ShardMesh(P8, device="cpu"),
                to_port(jb), vals, thresh)

    def test_skips_blocks_and_streams_bit_identical(self, eight_devices):
        from spark_rapids_jni_tpu.shuffle import MorselSource as JSrc
        from spark_rapids_jni_tpu.shuffle import ShuffleRegistry as JReg
        from spark_rapids_jni_tpu.shuffle import ShuffleService as JSvc

        from spark_rapids_jni_tpu_torch.shuffle import (MorselSource,
                                                        ShuffleRegistry,
                                                        ShuffleService)

        jm, jb, tm, tb, vals, thresh = self._setup()
        jzone = JE.encode_for(jcol_i64(vals), block=256).zone
        tzone = E.encode_for(tcol_i64(vals), block=256).zone
        assert tzone.crc == jzone.crc
        pred = ("x", "<", thresh)
        jsrc = JSrc.from_batch(jb, jm, morsel_rows=128, predicate=pred,
                               zone_map=jzone)
        tsrc = MorselSource.from_batch(tb, tm, morsel_rows=128,
                                       predicate=pred, zone_map=tzone)
        assert tsrc.blocks_skipped > 0
        assert (len(tsrc), tsrc.blocks_skipped, tsrc.blocks_scanned) == \
            (len(jsrc), jsrc.blocks_skipped, jsrc.blocks_scanned)
        reg = ShuffleRegistry()
        tsvc = ShuffleService(tm, registry=reg)
        jres = JSvc(jm, registry=JReg()).exchange_stream(jsrc,
                                                         key_names=["k"])
        tres = tsvc.exchange_stream(tsrc, key_names=["k"])
        assert_same_exchange(jres, tres)
        assert tres.blocks_skipped == tsrc.blocks_skipped
        full = tsvc.exchange_stream(
            MorselSource.from_batch(tb, tm, morsel_rows=128),
            key_names=["k"])

        def survivors(r):
            xs, vs = r.batch["x"].data.numpy(), r.batch["x"].validity.numpy()
            ks = r.batch["k"].data.numpy()
            rows = len(xs) // P8
            return [sorted((k, x) for k, x, v in zip(
                ks[d * rows:(d + 1) * rows], xs[d * rows:(d + 1) * rows],
                vs[d * rows:(d + 1) * rows]) if v and x < thresh)
                for d in range(P8)]

        assert survivors(tres) == survivors(full)
        snap = reg.metrics.snapshot()
        assert snap["blocks_skipped"] >= tsrc.blocks_skipped
        assert snap["blocks_scanned"] >= tsrc.blocks_scanned > 0

    def test_all_excluded_keeps_schema_morsel(self, eight_devices):
        from spark_rapids_jni_tpu_torch.shuffle import MorselSource

        _jm, _jb, tm, tb, vals, _t = self._setup()
        zone = E.encode_for(tcol_i64(vals), block=256).zone
        src = MorselSource.from_batch(
            tb, tm, morsel_rows=128, predicate=("x", "<", int(vals.min())),
            zone_map=zone)
        assert len(src) == 1 and src.blocks_skipped > 0

    def test_none_excluded_scans_everything(self, eight_devices):
        from spark_rapids_jni_tpu_torch.shuffle import MorselSource

        _jm, _jb, tm, tb, vals, _t = self._setup()
        zone = E.encode_for(tcol_i64(vals), block=256).zone
        src = MorselSource.from_batch(
            tb, tm, morsel_rows=128, predicate=("x", "<=", int(vals.max())),
            zone_map=zone)
        assert src.blocks_skipped == 0 and src.blocks_scanned > 0

    def test_wrong_column_sidecar_never_skips(self, eight_devices):
        from spark_rapids_jni_tpu_torch.shuffle import MorselSource

        _jm, _jb, tm, tb, vals, thresh = self._setup()
        wrong = E.encode_for(tcol_i64(vals), block=256, column="k").zone
        src = MorselSource.from_batch(tb, tm, morsel_rows=128,
                                      predicate=("x", "<", thresh),
                                      zone_map=wrong)
        assert src.blocks_skipped == 0 and src.blocks_scanned == 0
        tagged = E.encode_for(tcol_i64(vals), block=256, column="x").zone
        src = MorselSource.from_batch(tb, tm, morsel_rows=128,
                                      predicate=("x", "<", thresh),
                                      zone_map=tagged)
        assert src.blocks_skipped > 0

    def test_corrupt_sidecar_refuses_to_skip(self, eight_devices):
        from spark_rapids_jni_tpu_torch.shuffle import MorselSource

        _jm, _jb, tm, tb, vals, thresh = self._setup()
        zone = E.encode_for(tcol_i64(vals), block=256).zone
        lying = dataclasses.replace(zone, maxs=zone.maxs ^ np.int64(1))
        with pytest.raises(E.ZoneMapCorruptionError):
            MorselSource.from_batch(tb, tm, morsel_rows=128,
                                    predicate=("x", "<", thresh),
                                    zone_map=lying)

    def test_reused_source_records_counters_once(self, eight_devices):
        from spark_rapids_jni_tpu_torch.shuffle import (MorselSource,
                                                        ShuffleRegistry,
                                                        ShuffleService)

        _jm, _jb, tm, tb, vals, thresh = self._setup()
        zone = E.encode_for(tcol_i64(vals), block=256).zone
        reg = ShuffleRegistry()
        svc = ShuffleService(tm, registry=reg)
        src = MorselSource.from_batch(tb, tm, morsel_rows=128,
                                      predicate=("x", "<", thresh),
                                      zone_map=zone)
        first = svc.exchange_stream(src, key_names=["k"])
        assert first.blocks_skipped == src.blocks_skipped > 0
        base = reg.metrics.snapshot()["blocks_skipped"]
        second = svc.exchange_stream(src, key_names=["k"])
        assert second.blocks_skipped == 0
        assert reg.metrics.snapshot()["blocks_skipped"] == base
        assert src.blocks_skipped > 0

    def test_knob_off_never_skips(self, eight_devices):
        from spark_rapids_jni_tpu_torch.shuffle import MorselSource

        _jm, _jb, tm, tb, vals, thresh = self._setup()
        zone = E.encode_for(tcol_i64(vals), block=256).zone
        tconfig.set("zone_maps", False)
        src = MorselSource.from_batch(tb, tm, morsel_rows=128,
                                      predicate=("x", "<", thresh),
                                      zone_map=zone)
        assert src.blocks_skipped == 0 and src.blocks_scanned == 0
