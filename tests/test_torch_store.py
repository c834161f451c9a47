"""The port's CRDT store (`corrosion_tpu_torch/store/`) against the JAX
package's: remote apply under each merge engine, the store's scenarios,
the books, database files carried across, the device rule and the host
libraries' builds.

The same inputs go through both stores: the reference tests' generators
make the reference's changes, `convert.changes_to_port` carries them
across, and each comparison is exact (final dumps with clocks, causal
lengths and db_versions, impactful changes in order). The reference
store runs its `python` engine, which its own suite holds equal to its
native and array engines; the port's array engine runs its decision
program on the CPU (`device="cpu"`).

    JAX_PLATFORMS=cpu python -m tests.test_torch_store

prints `chip_smoke.STORE_PARITY_REF`, `INGEST_REF` and `STORE_FLOOD_REF`
(the flood's JAX array-engine runs compile once per pad size: a few
minutes).
"""

import ast
import importlib.util
import itertools
import random
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from corrosion_tpu.runtime import metrics as jmetrics
from corrosion_tpu.runtime.records import FLIGHT as JFLIGHT
from corrosion_tpu.store import schema as jschema
from corrosion_tpu.store.crdt import CrdtStore as JStore
from corrosion_tpu.types import codec as jcodec
from corrosion_tpu.types.actor import ActorId as JActorId
from corrosion_tpu.types.base import Timestamp as JTimestamp
from corrosion_tpu.types.change import Change as JChange
from corrosion_tpu.types.change import ChangesetFull as JChangesetFull
from corrosion_tpu.types.pack import pack_columns as jpack
from corrosion_tpu_torch import convert
from corrosion_tpu_torch import crdt_bench as cb
from corrosion_tpu_torch import ingest_bench as ib
from corrosion_tpu_torch import native as tnative
from corrosion_tpu_torch import store_checks as sc
from corrosion_tpu_torch.store import schema as tschema
from corrosion_tpu_torch.store.crdt import CrdtStore as TStore
from corrosion_tpu_torch.types.actor import ActorId as TActorId
from corrosion_tpu_torch.types.base import Timestamp as TTimestamp
from tests.test_crdt_batch import random_changes, random_rich_changes

ROOT = Path(__file__).resolve().parent.parent
ENGINES = ("python", "native", "array")

JAPI = SimpleNamespace(
    new_store=lambda site: JStore(":memory:", site_id=JActorId(site)),
    Change=JChange, ChangesetFull=JChangesetFull, ActorId=JActorId,
    Timestamp=JTimestamp, pack_columns=jpack, Writer=jcodec.Writer,
    Reader=jcodec.Reader, write_changeset=jcodec.write_changeset,
    read_changeset=jcodec.read_changeset,
)


def tapi():
    return sc.port_api("cpu")


# -- remote apply ------------------------------------------------------------


def _groups():
    return {
        "randomized": [(random_changes(random.Random(3000 + s), 120), None)
                       for s in range(4)],
        "rich_values": [(random_rich_changes(random.Random(4000 + s), 150),
                         None) for s in range(4)],
        "split_batches": [(random_changes(random.Random(5151), 180), 13),
                          (random_rich_changes(random.Random(4242), 180),
                           11)],
        "even_cl_with_cid": [(c, None) for c in sc.even_cl_cases(JAPI)],
        "value_ties": [(c, None) for c in sc.tie_cases(JAPI)],
    }


@pytest.mark.parametrize("group", ["randomized", "rich_values",
                                   "split_batches", "even_cl_with_cid",
                                   "value_ties"])
@pytest.mark.parametrize("engine", ENGINES)
def test_remote_apply_matches_jax_store(engine, group):
    mark = cb.lane_mark()
    for jchs, split in _groups()[group]:
        with cb.engine_env("python"):
            want = sc.parity_run(JAPI, jchs, split)
        with cb.engine_env(engine):
            got = sc.parity_run(tapi(), convert.changes_to_port(jchs), split)
        assert got == want
    lane = cb.lane_since(mark)
    if engine != "array":
        assert lane["decided"] == lane["declined"] == 0
    elif group == "value_ties":
        # the decision program declines both batches; a host engine
        # decides them, with the reference's result
        assert lane["declined"] == 2 and lane["decided"] == 0
    else:
        assert lane["decided"] > 0 and lane["declined"] == 0


def test_generators_are_the_reference_tests():
    fields = sc.change_fields
    for seed in (3000, 5151):
        assert ([fields(c) for c in sc.random_changes(
                    tapi(), random.Random(seed), 150)]
                == [fields(c) for c in random_changes(
                    random.Random(seed), 150)])
        assert ([fields(c) for c in sc.random_rich_changes(
                    tapi(), random.Random(seed), 150)]
                == [fields(c) for c in random_rich_changes(
                    random.Random(seed), 150)])
    jchs = random_rich_changes(random.Random(1), 40)
    assert [fields(c) for c in convert.changes_to_port(jchs)] == \
        [fields(c) for c in jchs]


def test_array_engine_needs_cuda_by_default(monkeypatch):
    """No device named: the first array merge takes the card, and without
    CUDA it raises; it never falls through to a host engine."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chs = convert.changes_to_port(random_changes(random.Random(1), 20))
    with cb.engine_env("array"):
        st = TStore(":memory:")
        st.apply_schema_sql(sc.SCHEMA)
        with pytest.raises(RuntimeError, match="CUDA"):
            st.apply_changes(chs)
        # the batch rolled back whole
        assert st._conn.execute("SELECT COUNT(*) FROM kv").fetchone()[0] == 0
    with cb.engine_env("python"):
        assert st.apply_changes(chs).impactful
    st.close()


# -- the reference store's scenarios (tests/test_crdt_store.py) ---------------

SCHEMA = """
CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY, text TEXT NOT NULL DEFAULT '');
CREATE TABLE tests2 (id INTEGER NOT NULL PRIMARY KEY, text TEXT NOT NULL DEFAULT '');
CREATE TABLE testsblob (id BLOB NOT NULL PRIMARY KEY, text TEXT NOT NULL DEFAULT '');
"""


class Side:
    """One package's store API with fixed timestamps."""

    def __init__(self, api, store_cls, schema_mod):
        self.api, self.store_cls, self.schema = api, store_cls, schema_mod
        self.clock = 0

    def ts(self):
        self.clock += 1
        return self.api.Timestamp.from_unix(self.clock)

    def store(self, site_byte=1, path=":memory:"):
        s = self.store_cls(path, site_id=self.api.ActorId(
            bytes([site_byte]) * 16))
        s.apply_schema_sql(SCHEMA)
        return s

    def write(self, store, sql, params=()):
        with store.write_tx(self.ts()) as tx:
            tx.execute(sql, params)
            chs, v, last = tx.commit()
        return [sc.change_fields(c) for c in chs], v, last, chs


def _rows(store, table="tests"):
    return [tuple(r) for r in store._conn.execute(
        f"SELECT * FROM {table} ORDER BY 1")]


def _res(res):
    return ([sc.change_fields(c) for c in res.impactful],
            dict(res.changed_tables))


def _schema_errors(x):
    out = []
    for sql in ("CREATE TABLE nopk (a INTEGER);",
                "CREATE TABLE u (id INTEGER PRIMARY KEY, x TEXT UNIQUE);",
                "CREATE TABLE a (id INTEGER PRIMARY KEY);"
                "CREATE TABLE b (id INTEGER PRIMARY KEY,"
                " a_id INTEGER REFERENCES a(id));",
                "CREATE TABLE n (id INTEGER PRIMARY KEY, x TEXT NOT NULL);",
                'CREATE TABLE t (id INTEGER PRIMARY KEY, "a\'b" TEXT);'):
        with pytest.raises(x.schema.SchemaError) as e:
            x.schema.parse_sql(sql)
        out.append(str(e.value))
    ok = x.schema.parse_sql(SCHEMA)
    return out, sorted(ok.tables), ok.tables["tests"].pk_cols, \
        ok.tables["tests"].non_pk_cols


def _add_column_and_index(x):
    s = x.store()
    s.apply_schema_sql(SCHEMA + "\nCREATE INDEX tests_text ON tests (text);")
    idx = sorted(s.schema.tables["tests"].indexes)
    s.apply_schema_sql(SCHEMA.replace(
        "text TEXT NOT NULL DEFAULT '');",
        "text TEXT NOT NULL DEFAULT '', num INTEGER);", 1))
    w = x.write(s, "INSERT INTO tests (id, text, num) VALUES (1, 'a', 5)")
    return idx, w[:3], _rows(s), cb.dump_state(s)


def _destructive_refused(x):
    s = x.store()
    with pytest.raises(x.schema.SchemaError) as e:
        s.apply_schema_sql("CREATE TABLE tests (id INTEGER NOT NULL PRIMARY"
                           " KEY, text TEXT NOT NULL DEFAULT '');")
    return str(e.value)


def _local_changes(x):
    s = x.store()
    out = [x.write(s, "INSERT INTO tests (id, text) VALUES (1, 'hello')")[:3],
           x.write(s, "UPDATE tests SET text = 'b' WHERE id = 1")[:3],
           x.write(s, "UPDATE tests SET text = 'b' WHERE id = 1")[:3],
           x.write(s, "DELETE FROM tests WHERE id = 1")[:3],
           x.write(s, "INSERT INTO tests (id, text) VALUES (1, 'back')")[:3]]
    return out, cb.dump_state(s)


def _pk_change(x):
    out = []
    for sql in ("UPDATE tests SET id = 2 WHERE id = 1",
                "UPDATE tests SET id = 3, text = 'y' WHERE id = 1"):
        a, b = x.store(1), x.store(2)
        w1 = x.write(a, "INSERT INTO tests (id, text) VALUES (1, 'x')")
        b.apply_changes(w1[3])
        w2 = x.write(a, sql)
        out.append((w2[:3], _res(b.apply_changes(w2[3])), _rows(a), _rows(b),
                    cb.dump_state(b)))
    return out


def _multi_statement_and_rollback(x):
    s = x.store()
    with s.write_tx(x.ts()) as tx:
        tx.execute("INSERT INTO tests (id, text) VALUES (1, 'a')")
        tx.execute("INSERT INTO tests2 (id, text) VALUES (9, 'z')")
        chs, v, last = tx.commit()
    with pytest.raises(Exception):
        with s.write_tx(x.ts()) as tx:
            tx.execute("INSERT INTO tests (id, text) VALUES (2, 'b')")
            tx.execute("INSERT INTO nonexistent VALUES (1)")
    return ([sc.change_fields(c) for c in chs], v, last, _rows(s),
            s.db_version_for(s.site_id), cb.dump_state(s))


def _merge_rules(x):
    out = []
    a, b = x.store(1), x.store(2)
    w = x.write(a, "INSERT INTO tests (id, text) VALUES (1, 'a')")
    out.append(_res(b.apply_changes(w[3])))
    out.append(_res(b.apply_changes(w[3])))  # idempotent
    wb = x.write(b, "UPDATE tests SET text = 'b-wins' WHERE id = 1")
    out.append(_res(a.apply_changes(wb[3])))
    out.append(_res(a.apply_changes(w[3])))  # stale col_version loses
    out.append((_rows(a), _rows(b), cb.dump_state(a), cb.dump_state(b)))
    return out


def _concurrent_pairs(x):
    out = []
    scripts = [
        # equal col_version: the larger value wins everywhere
        (["INSERT INTO tests (id, text) VALUES (1, 'aaa')"],
         ["INSERT INTO tests (id, text) VALUES (1, 'zzz')"]),
        # equal values merge silently
        (["INSERT INTO tests (id, text) VALUES (1, 'same')"],
         ["INSERT INTO tests (id, text) VALUES (1, 'same')"]),
    ]
    for sa, sb in scripts:
        a, b = x.store(1), x.store(2)
        cha = [c for sql in sa for c in x.write(a, sql)[3]]
        chb = [c for sql in sb for c in x.write(b, sql)[3]]
        out.append((_res(a.apply_changes(chb)), _res(b.apply_changes(cha)),
                    _rows(a), _rows(b), cb.dump_state(a), cb.dump_state(b)))
    return out


def _delete_and_resurrection(x):
    out = []
    # a delete beats a concurrent update
    a, b = x.store(1), x.store(2)
    b.apply_changes(x.write(a, "INSERT INTO tests (id, text) VALUES (1,"
                               " 'x')")[3])
    del_b = x.write(b, "DELETE FROM tests WHERE id = 1")[3]
    upd_a = x.write(a, "UPDATE tests SET text = 'y' WHERE id = 1")[3]
    out.append((_res(a.apply_changes(del_b)), _res(b.apply_changes(upd_a)),
                cb.dump_state(a), cb.dump_state(b)))
    # a resurrection (cl 3) beats a delete (cl 2)
    a, b = x.store(1), x.store(2)
    b.apply_changes(x.write(a, "INSERT INTO tests (id, text) VALUES (1,"
                               " 'x')")[3])
    x.write(a, "DELETE FROM tests WHERE id = 1")
    res_a = x.write(a, "INSERT INTO tests (id, text) VALUES (1, 'back')")[3]
    del_b = x.write(b, "DELETE FROM tests WHERE id = 1")[3]
    out.append((_res(a.apply_changes(del_b)), _res(b.apply_changes(res_a)),
                cb.dump_state(a), cb.dump_state(b)))
    return out


def _all_orders(x):
    base = x.store(9)
    ch0 = x.write(base, "INSERT INTO tests (id, text) VALUES (1, 'base')")[3]
    sets = []
    for site, sql in [(1, "UPDATE tests SET text = 'alpha' WHERE id = 1"),
                      (2, "DELETE FROM tests WHERE id = 1"),
                      (3, "INSERT INTO tests (id, text) VALUES (2, 'two')")]:
        s = x.store(site)
        s.apply_changes(ch0)
        sets.append(x.write(s, sql)[3])
    out = []
    for perm in itertools.permutations(range(3)):
        r = x.store(50)
        r.apply_changes(ch0)
        res = [_res(r.apply_changes(sets[i])) for i in perm]
        out.append((res, cb.dump_state(r)))
    return out


def _blob_pks(x):
    s, b = x.store(1), x.store(2)
    w = x.write(s, "INSERT INTO testsblob (id, text) VALUES (?, 'v')",
                (b"\x01\x02",))
    return w[:3], _res(b.apply_changes(w[3])), cb.dump_state(b)


def _serving_versions(x):
    a, b = x.store(1), x.store(2)
    x.write(a, "INSERT INTO tests (id, text) VALUES (1, 'one')")
    x.write(a, "INSERT INTO tests (id, text) VALUES (2, 'two')")
    x.write(a, "UPDATE tests SET text = 'new' WHERE id = 1")
    served = list(a.changes_for_versions(a.site_id, 1, 3))
    res = [_res(b.apply_changes(chs)) for _, chs in served]
    return ([(v, [sc.change_fields(c) for c in chs]) for v, chs in served],
            res, cb.dump_state(b))


def _partials_and_books(x):
    a, b = x.store(1), x.store(2)
    with a.write_tx(x.ts()) as tx:
        for i in range(10):
            tx.execute(f"INSERT INTO tests (id, text) VALUES ({i}, 'v{i}')")
        chs, version, last_seq = tx.commit()
    half = len(chs) // 2
    b.buffer_partial_changes(a.site_id, version, chs[half:],
                             (chs[half].seq, last_seq), last_seq, x.ts())
    first = [c.seq for c in b.take_buffered_version(a.site_id, version)]
    ranges = b.buffered_seq_ranges(a.site_id, version)
    b.buffer_partial_changes(a.site_id, version, chs[:half],
                             (0, chs[half - 1].seq), last_seq, x.ts())
    buffered = b.take_buffered_version(a.site_id, version)
    res = _res(b.apply_changes(buffered))
    b.clear_buffered_version(a.site_id, version)
    bv = a.load_booked_versions(a.site_id)
    return (first, list(ranges), [sc.change_fields(c) for c in buffered],
            res, b.take_buffered_version(a.site_id, version),
            bv.max, [s.bytes16 for s in a.booked_actor_ids()],
            list(a.present_versions(a.site_id)), cb.dump_state(b))


def _table_rebuild(x, tmp_path):
    s = x.store_cls(str(tmp_path / "r.db"),
                    site_id=x.api.ActorId(bytes([4]) * 16))
    s.apply_schema_sql("CREATE TABLE m (id INTEGER PRIMARY KEY, n TEXT,"
                       " o TEXT);")
    with s.write_tx(x.ts()) as tx:
        tx.execute("INSERT INTO m (id, n, o) VALUES (1, '42', 'keep')")
        tx.execute("INSERT INTO m (id, n, o) VALUES (2, '7', 'also')")
        tx.commit()
    s.apply_schema_sql("CREATE TABLE m (id INTEGER PRIMARY KEY, n INTEGER,"
                       " o TEXT);")
    with s.write_tx(x.ts()) as tx:
        tx.execute("INSERT INTO m (id, n, o) VALUES (3, 9, 'post')")
        post = [sc.change_fields(c) for c in tx.commit()[0]]
    first = cb.dump_state(s)
    s.close()
    # a changed default and an added column in one migration
    s2 = x.store_cls(str(tmp_path / "r2.db"),
                     site_id=x.api.ActorId(bytes([5]) * 16))
    s2.apply_schema_sql("CREATE TABLE m (id INTEGER PRIMARY KEY, a TEXT);")
    with s2.write_tx(x.ts()) as tx:
        tx.execute("INSERT INTO m (id, a) VALUES (1, 'x')")
        tx.commit()
    s2.apply_schema_sql("CREATE TABLE m (id INTEGER PRIMARY KEY, a TEXT"
                        " DEFAULT 'dflt', b INTEGER DEFAULT 5);")
    s2._conn.execute("INSERT INTO m (id) VALUES (99)")
    out = (post, s.schema.tables["m"].columns["n"].sql_type, first,
           cb.dump_state(s2))
    s2.close()
    return out


SCENARIOS = {
    "schema_constraints": _schema_errors,
    "add_column_and_index": _add_column_and_index,
    "destructive_migration_refused": _destructive_refused,
    "insert_update_noop_delete_resurrect": _local_changes,
    "pk_change": _pk_change,
    "multi_statement_and_rollback": _multi_statement_and_rollback,
    "lww_idempotent_stale": _merge_rules,
    "value_tiebreak_and_equal_merge": _concurrent_pairs,
    "delete_vs_update_and_resurrection": _delete_and_resurrection,
    "all_orders_converge": _all_orders,
    "blob_pks": _blob_pks,
    "changes_for_versions_and_overwrites": _serving_versions,
    "buffered_partials_and_books": _partials_and_books,
    "table_rebuild": _table_rebuild,
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_store_scenario_matches_jax_store(name, engine, tmp_path):
    fn = SCENARIOS[name]
    def extra(side):
        if name != "table_rebuild":
            return ()
        (tmp_path / side).mkdir()
        return (tmp_path / side,)

    with cb.engine_env("python"):
        want = fn(Side(JAPI, JStore, jschema), *extra("jax"))
    with cb.engine_env(engine):
        got = fn(Side(tapi(), lambda p, **kw: TStore(p, device="cpu", **kw),
                      tschema), *extra("port"))
    assert got == want


# -- database files carried across -------------------------------------------


@pytest.mark.parametrize("first", ["jax", "port"])
def test_database_file_opens_both_ways(first, tmp_path):
    """One package writes a file; the other opens it and applies more
    changes, and ends equal to the first package doing the same."""
    chs = random_rich_changes(random.Random(11), 160)
    more = random_changes(random.Random(12), 120)
    stores = {
        "jax": lambda p, site=None: JStore(
            p, site_id=site and JActorId(site)),
        "port": lambda p, site=None: TStore(
            p, site_id=site and TActorId(site), device="cpu"),
    }
    ported = {"jax": lambda c: c, "port": convert.changes_to_port}
    second = "port" if first == "jax" else "jax"
    dumps = []
    for opener in (second, first):
        path = str(tmp_path / f"{opener}.db")
        st = stores[first](path, bytes([6]) * 16)
        st.apply_schema_sql(sc.SCHEMA)
        with cb.engine_env("python"):
            st.apply_changes(ported[first](chs))
        with st.write_tx(TTimestamp(1 << 32) if first == "port"
                         else JTimestamp(1 << 32)) as tx:
            tx.execute("INSERT INTO kv (id, a, b) VALUES (77, 'loc', 5)")
            tx.commit()
        site = st.site_id.bytes16
        st.close()
        st = stores[opener](path)
        assert st.site_id.bytes16 == site
        with cb.engine_env("native"):
            imp = st.apply_changes(ported[opener](more)).impactful
        dumps.append(([sc.change_fields(c) for c in imp],
                      cb.dump_state(st)))
        st.close()
    assert dumps[0] == dumps[1]


# -- host libraries ----------------------------------------------------------


def test_native_libraries_build_once_in_parallel(tmp_path):
    """Two processes that build the libraries at once each load a whole
    library, named for the source's hash."""
    code = (
        "import sys; from pathlib import Path\n"
        "from corrosion_tpu_torch import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "assert native.merge_batch_lib() is not None\n"
        "assert native.finalize_batch_lib() is not None\n"
        "print(native.status())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    built = sorted(p.name for p in tmp_path.iterdir())
    want = [tnative.library_path(tnative.BATCH_SRC).name]
    include = tnative._sqlite_include_dir()
    if include is not None:
        want.append(tnative.library_path(tnative.EXT_SRC, include).name)
    assert built == sorted(want)
    assert tnative.BUILD_DIR == ROOT / "corrosion_tpu_torch" / "_build"
    assert tnative.library_path(tnative.BATCH_SRC).parent == tnative.BUILD_DIR


def test_native_engines_load_here():
    """The merge and finalize engines load on this host, so the `native`
    cases above run native code, not the Python fallback."""
    assert tnative.status()["merge_batch"]
    assert tnative.status()["finalize_batch"]


# -- the copied programs -----------------------------------------------------


def script_functions(script, names, **ns):
    """The named module-level functions of a script, compiled from its
    source into a namespace holding `ns` (importing the script would run
    its set-up)."""
    tree = ast.parse((ROOT / "scripts" / script).read_text())
    keep = [node for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.module == "__future__"
            or isinstance(node, ast.FunctionDef) and node.name in names]
    exec(compile(ast.Module(body=keep, type_ignores=[]), script, "exec"), ns)
    return ns


def test_benches_are_the_scripts():
    """`crdt_bench.schedule` (pks included) and `ingest_bench`'s streams
    are the scripts' change for change."""
    spec = importlib.util.spec_from_file_location(
        "bench_crdt_merge", ROOT / "scripts" / "bench_crdt_merge.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    rng = random.Random(cb.SEED)
    for size, warm, batches in cb.schedule((512, 4096)):
        want = [ref.synth_batch(rng, min(size, 2048), cb.HOT_ROWS)]
        want += [ref.synth_batch(rng, size, cb.HOT_ROWS) for _ in range(3)]
        assert [[sc.change_fields(c) for c in b] for b in [warm, *batches]] \
            == [[sc.change_fields(c) for c in b] for b in want]
    ing = script_functions(
        "bench_ingest.py", ("_gen_uniform", "_gen_conflict"),
        random=random, ActorId=JActorId, Timestamp=JTimestamp,
        Change=JChange, SENTINEL="-1", pack_columns=jpack)
    got = ib.rungs()
    for name, want in (("ingest-remote", ing["_gen_uniform"](20_000, 400)),
                       ("ingest-conflict", ing["_gen_conflict"](20_000))):
        assert [sc.change_fields(c) for c in got[name]] == \
            [sc.change_fields(c) for c in want]
    assert (ib.BATCH, ib.ROWS) == (500, 20_000)
    assert ib.SCHEMA in (ROOT / "scripts" / "bench_ingest.py").read_text() \
        .replace('"\n    "', "")


# -- the chip_smoke references -------------------------------------------------


def jax_parity_ref() -> dict:
    with cb.engine_env("python"):
        return sc.parity_digests(JAPI)


def jax_ingest_ref() -> dict:
    """Per rung, the digest of the reference store's final state after the
    script's `_apply_rung` (python engine, file-backed, batches of 500)."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp, cb.engine_env("python"):
        for rung, tchs in ib.rungs().items():
            st = JStore(str(Path(tmp) / f"{rung}.db"))
            st.apply_schema_sql(ib.SCHEMA)
            jchs = [JChange(table=c.table, pk=c.pk, cid=c.cid, val=c.val,
                            col_version=c.col_version,
                            db_version=c.db_version, seq=c.seq,
                            site_id=c.site_id, cl=c.cl,
                            ts=JTimestamp(c.ts.ntp64)) for c in tchs]
            for i in range(0, len(jchs), ib.BATCH):
                st.apply_changes(jchs[i:i + ib.BATCH])
            out[rung] = cb.state_digest(st)
            st.close()
    return out


def jax_flood_ref(sizes=cb.SIZES) -> dict:
    """Per size of the schedule, the reference store's final-state digest
    after `crdt_bench.bench_engine` (python engine) and what its array
    engine's `crdt_merge` lane saw over the same run (decided and
    declined batches, event totals), on the reference script's batches."""
    spec = importlib.util.spec_from_file_location(
        "bench_crdt_merge", ROOT / "scripts" / "bench_crdt_merge.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    def new_store():
        st = JStore(":memory:", site_id=JActorId(bytes([9]) * 16))
        st.apply_schema_sql(cb.KV_SCHEMA)
        return st

    rng = random.Random(cb.SEED)
    lane = (JFLIGHT, jmetrics.METRICS, jmetrics.kernel_event_totals)
    out = {}
    for size in sizes:
        warm = ref.synth_batch(rng, min(size, 2048), cb.HOT_ROWS)
        batches = [ref.synth_batch(rng, size, cb.HOT_ROWS) for _ in range(3)]
        py = cb.bench_engine("python", batches, warm, new_store=new_store)
        arr = cb.bench_engine("array", batches, warm, new_store=new_store,
                              lane=lane)
        assert arr["digest"] == py["digest"], size
        out[size] = {"digest": py["digest"], **arr["lane"]}
    return out


def test_chip_smoke_parity_ref_is_the_jax_stores():
    import chip_smoke

    assert chip_smoke.STORE_PARITY_REF == jax_parity_ref()
    with cb.engine_env("python"):
        assert sc.parity_digests(tapi()) == chip_smoke.STORE_PARITY_REF


def test_chip_smoke_ingest_ref_is_the_jax_stores():
    import chip_smoke

    assert chip_smoke.INGEST_REF == jax_ingest_ref()
    got = ib.run(("python",), device="cpu")["rungs"]
    assert {r["rung"]: r["digest"] for r in got} == chip_smoke.INGEST_REF


def test_chip_smoke_flood_ref_at_512():
    """The smallest size of the flood reference, on both stores: the
    port's three engines end at the reference's digest, and the port's
    array engine sees the reference array engine's lane."""
    import chip_smoke

    ref = chip_smoke.STORE_FLOOD_REF[512]
    got = cb.run_ab((512,), device="cpu")["rungs"][0]["end_to_end"]
    assert {r["engine"]: r["digest"] for r in got} == dict.fromkeys(
        ENGINES, ref["digest"])
    lane = got[-1]["lane"]
    assert {k: lane[k] for k in ("decided", "declined", "events")} == \
        {k: ref[k] for k in ("decided", "declined", "events")}


@pytest.mark.slow
def test_chip_smoke_flood_ref_is_the_jax_stores():
    """Every size, with the reference's array engine on the CPU (a few
    minutes: one compile per pad size)."""
    import chip_smoke

    assert chip_smoke.STORE_FLOOD_REF == jax_flood_ref()


if __name__ == "__main__":
    print(f"STORE_PARITY_REF = {jax_parity_ref()!r}")
    print(f"INGEST_REF = {jax_ingest_ref()!r}")
    print("STORE_FLOOD_REF = {")
    for size, rec in jax_flood_ref().items():
        print(f"    {size}: {rec!r},")
    print("}", flush=True)
