"""The port's local write path against the JAX package's: capture,
finalize, the change and changeset codecs, and three replicas that write
and exchange their versions.

Every comparison is exact: the changes each commit emits (fields, the
timestamp included), their cached wire bytes and `write_change_cells`
bytes, the final dumps, and the codec's bytes both ways. The knobs
(`CORRO_CAPTURE`, `CORRO_FINALIZE`, `CORRO_CRDT_ENGINE`) are read by both
stores alike.

    JAX_PLATFORMS=cpu python -m tests.test_torch_store_writes

prints `chip_smoke.REPLICA_REF` (a few seconds).
"""

import random

import pytest

from corrosion_tpu.store.crdt import CrdtStore as JStore
from corrosion_tpu.types import codec as jcodec
from corrosion_tpu.types.base import Timestamp as JTimestamp
from corrosion_tpu.types.change import (
    ChangesetEmpty as JEmpty,
    ChangesetEmptySet as JEmptySet,
    ChangesetFull as JFull,
)
from corrosion_tpu_torch import convert
from corrosion_tpu_torch import crdt_bench as cb
from corrosion_tpu_torch import store_checks as sc
from corrosion_tpu_torch.store.crdt import CrdtStore as TStore
from corrosion_tpu_torch.types import codec as tcodec
from corrosion_tpu_torch.types.actor import ActorId as TActorId
from corrosion_tpu_torch.types.base import Timestamp as TTimestamp
from corrosion_tpu_torch.types.change import (
    ChangesetEmpty as TEmpty,
    ChangesetEmptySet as TEmptySet,
    ChangesetFull as TFull,
)
from tests.test_finalize_batch import SCHEMA, SITE, random_txs
from tests.test_torch_store import JAPI, tapi

# -- local writes: capture and finalize ----------------------------------------


def _cells(codec, changes, site):
    return codec.write_change_cells(
        [(c.table, c.pk, c.cid, c.val, c.col_version, c.db_version, c.seq,
          c.cl) for c in changes], site)


def _run_writes(new_store, codec, ts_cls, txs):
    st = new_store()
    st.apply_schema_sql(SCHEMA)
    out = []
    for i, ops in enumerate(txs):
        with st.write_tx(ts_cls.from_unix(i + 1)) as tx:
            for sql, params in ops:
                try:
                    tx.execute(sql, params)
                except Exception:
                    pass  # a pk-change collision: both stores skip alike
            changes, version, last = tx.commit()
        out.append(([sc.change_fields(c) for c in changes], version, last,
                    [c.wire_cell for c in changes],
                    _cells(codec, changes, st.site_id.bytes16)))
    dump = cb.dump_state(st)
    st.close()
    return out, dump


@pytest.mark.parametrize("finalize", ["columnar", "vector", "percell",
                                      "native"])
@pytest.mark.parametrize("capture", ["direct", "trigger"])
def test_local_writes_match_jax_store(capture, finalize):
    seed = 10 * ("direct", "trigger").index(capture) + (
        "columnar", "vector", "percell", "native").index(finalize)
    txs = random_txs(random.Random(seed), 30)
    with cb.engine_env(capture, "CORRO_CAPTURE"), \
            cb.engine_env(finalize, "CORRO_FINALIZE"):
        want = _run_writes(lambda: JStore(":memory:", site_id=SITE), jcodec,
                           JTimestamp, txs)
        got = _run_writes(lambda: TStore(
            ":memory:", site_id=TActorId(SITE.bytes16), device="cpu"),
            tcodec, TTimestamp, txs)
    assert got == want
    assert any(chs for chs, *_ in got[0])


# -- the changeset codec ---------------------------------------------------------


def _changesets(rng):
    chs = sc.random_rich_changes(JAPI, rng, 60)
    chs += sc.random_changes(JAPI, rng, 60)
    ts = JTimestamp.from_unix(1234.5)
    return [
        JFull(version=7, changes=tuple(chs[:50]), seqs=(0, 49), last_seq=49,
              ts=ts),
        JFull(version=8, changes=tuple(chs[50:]), seqs=(3, 9), last_seq=20,
              ts=ts),
        JFull(version=9, changes=(), seqs=(0, 0), last_seq=0, ts=ts),
        JEmpty(versions=(3, 9), ts=ts),
        JEmpty(versions=(1, 1), ts=None),
        JEmptySet(versions=((1, 2), (5, 9)), ts=ts),
    ]


def _to_port(cs):
    if isinstance(cs, JFull):
        return TFull(cs.version, tuple(convert.changes_to_port(cs.changes)),
                     cs.seqs, cs.last_seq, TTimestamp(cs.ts.ntp64))
    ts = None if cs.ts is None else TTimestamp(cs.ts.ntp64)
    return (TEmpty(cs.versions, ts) if isinstance(cs, JEmpty)
            else TEmptySet(cs.versions, ts))


def _shape(cs):
    """A changeset as plain values (either package's)."""
    out = [type(cs).__name__, getattr(cs, "versions", None),
           getattr(cs, "version", None), getattr(cs, "seqs", None),
           getattr(cs, "last_seq", None),
           None if cs.ts is None else cs.ts.ntp64]
    out.append([sc.change_fields(c)[:9] for c in getattr(cs, "changes", ())])
    return out


def test_changeset_codec_bytes_both_ways():
    for cs in _changesets(random.Random(5)):
        jw, tw = jcodec.Writer(), tcodec.Writer()
        jcodec.write_changeset(jw, cs)
        tcodec.write_changeset(tw, _to_port(cs))
        assert tw.bytes() == jw.bytes()
        mine = tcodec.read_changeset(tcodec.Reader(jw.bytes()))
        theirs = jcodec.read_changeset(jcodec.Reader(tw.bytes()))
        assert _shape(mine) == _shape(theirs) == _shape(
            jcodec.read_changeset(jcodec.Reader(jw.bytes())))
    for v in sc.RICH_VALUES + [None, "x" * 300, b"\x00" * 40]:
        jw, tw = jcodec.Writer(), tcodec.Writer()
        jcodec.write_value(jw, v)
        tcodec.write_value(tw, v)
        assert tw.bytes() == jw.bytes()
        assert tcodec.read_value(tcodec.Reader(jw.bytes())) == \
            jcodec.read_value(jcodec.Reader(jw.bytes()))


# -- three replicas --------------------------------------------------------------


@pytest.mark.parametrize("engine", ["python", "array"])
def test_replicas_match_jax_stores(engine):
    with cb.engine_env("python"):
        want = sc.replica_digests(JAPI, 60)
    with cb.engine_env(engine):
        got = sc.replica_digests(tapi(), 60)
    assert got == want
    assert len(set(got["converged"].values())) == 1
    assert len(set(got["replicas"].values())) == 3  # orders differ


def jax_replica_ref() -> dict:
    with cb.engine_env("python"):
        return sc.replica_digests(JAPI)


def test_chip_smoke_replica_ref_is_the_jax_stores():
    import chip_smoke

    assert chip_smoke.REPLICA_REF == jax_replica_ref()


if __name__ == "__main__":
    print(f"REPLICA_REF = {jax_replica_ref()!r}", flush=True)
