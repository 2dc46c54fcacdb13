"""PyTorch port: ``ops/datetime_rebase.py`` and ``ops/timezones.py``
against the JAX package, bit for bit, and against independent oracles.

Rebase: seeded DATE days (pre-cutover, the 1582 gap, the cutover,
modern, int32 extremes) and TIMESTAMP micros (sub-day parts, the cutover
micro, int64 extremes) through both directions of both packages, then
the reference test's Julian-day-number oracles.  Time zones: seeded UTC
micros (sub-second, negative, the int64 extremes) through both
directions in every zone of the reference's test (Asia/Shanghai's
historic transitions among them) in both packages, the TZif tables
themselves, then ``tests/expr_oracle.py`` (Python's ``zoneinfo``) on the
port alone; an unsupported
zone raises in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import datetime_rebase as JR
from spark_rapids_jni_tpu.ops import timezones as JZ

from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.ops import datetime_rebase as TR
from spark_rapids_jni_tpu_torch.ops import timezones as TZ

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

from expr_oracle import zone_offset_micros as zi_offset_micros
from tests.test_datetime import oracle_g2j, oracle_j2g

MICROS_PER_DAY = 86400 * 10**6
REBASES = ["rebase_gregorian_to_julian", "rebase_julian_to_gregorian"]
ZONES = ["Asia/Shanghai", "Asia/Tokyo", "America/Phoenix", "UTC", "+08:00",
         "-09:30"]
CONVERTS = ["convert_timestamp_to_utc", "convert_utc_to_timezone"]

_rng = np.random.default_rng(61)
DAYS = np.concatenate([
    _rng.integers(-1_000_000, 100_000, 2000), np.arange(-141450, -141400),
    [0, 19000, -141427, -141428, -141438, -141437, 2**31 - 1 - 719470,
     -2**31 + 719470]]).astype(np.int32)
_d = _rng.integers(-700_000, 30_000, 2000)
MICROS = np.concatenate([
    _d * MICROS_PER_DAY + _rng.integers(0, MICROS_PER_DAY, 2000),
    [-12219292800000000, -12219292800000001, 0, -1, 1690000000000000,
     -2**63, 2**63 - 1]]).astype(np.int64)
UTC = np.concatenate([
    _rng.integers(-2_000_000_000, 2_000_000_000, 2000) * 10**6
    + _rng.integers(-10**6, 10**6, 2000),
    [-2**63, 2**63 - 1, -1, 0, -999999, -1000000]]).astype(np.int64)


def _cols(data, jt, tt, seed=5):
    valid = np.random.default_rng(seed).random(data.shape[0]) > 0.05
    return (JColumn(jnp.asarray(data), jnp.asarray(valid), jt),
            Column(torch.from_numpy(data), torch.from_numpy(valid), tt))


@pytest.mark.parametrize("fn", REBASES)
@pytest.mark.parametrize("kind", ["date", "timestamp"])
def test_rebase_bit_for_bit(fn, kind):
    data, jt, tt = ((DAYS, JT.DATE, TT.DATE) if kind == "date"
                    else (MICROS, JT.TIMESTAMP, TT.TIMESTAMP))
    jc, tc = _cols(data, jt, tt)
    ref, got = getattr(JR, fn)(jc), getattr(TR, fn)(tc)
    assert got.data.dtype == tc.data.dtype and got.dtype == tt
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.validity.numpy(), tc.validity.numpy())


def test_rebase_days_against_jdn_oracle():
    days = DAYS[:2050].tolist()
    col = Column(torch.tensor(days, dtype=torch.int32),
                 torch.ones(len(days), dtype=torch.bool), TT.DATE)
    g2j = TR.rebase_gregorian_to_julian(col).data.tolist()
    j2g = TR.rebase_julian_to_gregorian(col).data.tolist()
    assert g2j == [oracle_g2j(d) for d in days]
    assert j2g == [oracle_j2g(d) for d in days]


def test_rebase_micros_against_jdn_oracle():
    micros = MICROS[:2000].tolist()
    col = Column(torch.tensor(micros, dtype=torch.int64),
                 torch.ones(len(micros), dtype=torch.bool), TT.TIMESTAMP)
    for fn, oracle in ((TR.rebase_gregorian_to_julian, oracle_g2j),
                       (TR.rebase_julian_to_gregorian, oracle_j2g)):
        out = fn(col).data.tolist()
        for m, o in zip(micros, out):
            d, tod = divmod(m, MICROS_PER_DAY)
            want = m if m >= -12219292800000000 else \
                oracle(d) * MICROS_PER_DAY + tod
            assert o == want, m


def test_rebase_rejects_other_types():
    with pytest.raises(TypeError):
        TR.rebase_gregorian_to_julian(Column(
            torch.tensor([1]), torch.tensor([True]), TT.INT64))


@pytest.fixture(scope="module")
def dbs():
    return JZ.TimeZoneDB(), TZ.TimeZoneDB(device="cpu")


@pytest.mark.parametrize("zone", ZONES)
def test_zone_tables_equal(dbs, zone):
    jz, tz = dbs[0].zone(zone), dbs[1].zone(zone)
    for f in ("utc_instants", "tz_instants", "offsets"):
        np.testing.assert_array_equal(getattr(tz, f), getattr(jz, f))
    utc, loc, off = dbs[1].device_tables(zone)
    assert utc.device.type == "cpu" and off.dtype == torch.int32
    np.testing.assert_array_equal(loc.numpy(), jz.tz_instants)


@pytest.mark.parametrize("fn", CONVERTS)
@pytest.mark.parametrize("zone", ZONES)
def test_convert_bit_for_bit(dbs, zone, fn):
    jc, tc = _cols(UTC, JT.TIMESTAMP, TT.TIMESTAMP)
    ref = getattr(JZ, fn)(jc, zone, dbs[0])
    got = getattr(TZ, fn)(tc, zone, dbs[1])
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.validity.numpy(), tc.validity.numpy())


@pytest.mark.parametrize("zone", ZONES + ["Asia/Kolkata", "+8:00"])
def test_against_zoneinfo(dbs, zone):
    utc = UTC[:2000].tolist()
    col = Column(torch.tensor(utc, dtype=torch.int64),
                 torch.ones(len(utc), dtype=torch.bool), TT.TIMESTAMP)
    local = TZ.convert_utc_to_timezone(col, zone, dbs[1]).data.tolist()
    z = "+08:00" if zone == "+8:00" else zone
    want = [u + zi_offset_micros(z, u) for u in utc]
    assert local == want
    back = TZ.convert_timestamp_to_utc(
        Column(torch.tensor(want, dtype=torch.int64), col.validity,
               TT.TIMESTAMP), zone, dbs[1]).data.tolist()
    # ambiguous/skipped local times may resolve to the other side of a
    # transition; random samples nearly never land there
    assert sum(b != u for b, u in zip(back, utc)) <= 2


def test_shanghai_historic_transition(dbs):
    """1940-06-01: Shanghai switched UTC+8 -> UTC+9 (a DST gap)."""
    z = dbs[1].zone("Asia/Shanghai")
    i = int(np.searchsorted(z.utc_instants, -934000000))
    t = int(z.utc_instants[i])
    before, after = int(z.offsets[i - 1]), int(z.offsets[i])
    assert before != after
    us = [(t - 10) * 10**6, (t + 10) * 10**6]
    col = Column(torch.tensor(us), torch.ones(2, dtype=torch.bool),
                 TT.TIMESTAMP)
    out = TZ.convert_utc_to_timezone(col, "Asia/Shanghai", dbs[1])
    assert out.data.tolist() == [us[0] + before * 10**6,
                                 us[1] + after * 10**6]


def test_unsupported_zone_raises(dbs):
    col = Column(torch.tensor([0]), torch.tensor([True]), TT.TIMESTAMP)
    assert not dbs[1].is_supported("America/New_York")
    assert not dbs[1].is_supported("Not/AZone")
    assert dbs[1].is_supported("+8:00")
    for db in dbs:
        with pytest.raises(ValueError, match="unsupported time zone"):
            (JZ if db is dbs[0] else TZ).convert_timestamp_to_utc(
                col if db is dbs[1] else JColumn(
                    jnp.asarray([0]), jnp.asarray([True]), JT.TIMESTAMP),
                "America/New_York", db)
    with pytest.raises(TypeError):
        TZ.convert_utc_to_timezone(Column(torch.tensor([0]),
                                          torch.tensor([True]), TT.INT64),
                                   "UTC", dbs[1])
