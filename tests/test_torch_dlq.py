"""The port's dead-letter store and ModelStore artifacts against the JAX
package's: the same records write the same files byte for byte, a store
written by either package replays in the other, commits are idempotent per
epoch, and the counters and events are the reference's. Neither module
needs jax.
"""

import json
import os

import pytest

from mmlspark_tpu.dataguard import dlq as jdlq
from mmlspark_tpu.dataguard import modes as jmodes
from mmlspark_tpu.observability import events as jevents
from mmlspark_tpu.observability import registry as jregistry
from mmlspark_tpu.runtime import journal as jjournal
from mmlspark_tpu_torch.dataguard import dlq as tdlq
from mmlspark_tpu_torch.dataguard import modes as tmodes
from mmlspark_tpu_torch.observability import events as tevents
from mmlspark_tpu_torch.observability import registry as tregistry
from mmlspark_tpu_torch.runtime import journal as tjournal

PORT = dict(dlq=tdlq, modes=tmodes, events=tevents, registry=tregistry, journal=tjournal)
REF = dict(dlq=jdlq, modes=jmodes, events=jevents, registry=jregistry, journal=jjournal)


def _records(modes):
    return [
        modes.CorruptRecord(source="shard-0003.npz", index=-1, reason="BadZipFile",
                            detail="File is not a zip file"),
        modes.CorruptRecord(source="events/000001.jsonl", index=17, reason="JSONDecodeError"),
        {"source": "request", "index": 4, "reason": "schema", "detail": "missing 'x'"},
    ]


def _letter(pkg, root):
    """One script against a store: two fresh epochs, a replayed one, a
    batch letter and an empty one; returns what it saw and published."""
    reg = pkg["registry"].MetricsRegistry()
    bus = pkg["events"].get_bus()
    seen = []
    bus.add_listener(seen.append)
    try:
        store = pkg["dlq"].DeadLetterStore(root, name="stream-q", registry=reg)
        recs = _records(pkg["modes"])
        out = [store.commit_epoch(3, recs[:2]), store.commit_epoch(3, recs[:2]),
               store.commit_epoch(5, recs[2:]), store.letter(recs), store.letter([]),
               store.commit_epoch(9, []), store.has_epoch(3), store.has_epoch(4),
               store.epochs(), store.count()]
    finally:
        bus.remove_listener(seen.append)
    events = [{k: v for k, v in e.to_record().items() if k != "t"} for e in seen]
    return out, events, reg.exposition()


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_the_same_records_write_the_references_files_counters_and_events(tmp_path):
    port = _letter(PORT, str(tmp_path / "port"))
    jref = _letter(REF, str(tmp_path / "ref"))
    assert port == jref
    assert port[0][:4] == [True, False, True, 6] and port[0][-2:] == [[3, 5, 6], 6]
    assert [e["event"] for e in port[1]] == ["RecordsDeadLettered"] * 3
    assert 'dataguard_quarantined_total{source="stream-q"} 6' in port[2]
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert not any(n.endswith(".tmp") for n in _files(tmp_path / "port"))


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)],
                         ids=["port_to_ref", "ref_to_port"])
def test_a_store_written_by_either_package_replays_in_the_other(tmp_path, writer, reader):
    _letter(writer, str(tmp_path))
    reg = reader["registry"].MetricsRegistry()
    store = reader["dlq"].DeadLetterStore(str(tmp_path), name="stream-q", registry=reg)
    want = [reader["modes"].CorruptRecord(**r) if isinstance(r, dict) else
            reader["modes"].CorruptRecord(**r.to_record()) for r in _records(writer["modes"])]
    got = store.replay()
    assert [r.to_record() for r in got] == [r.to_record() for r in want[:2] + want[2:] + want]
    assert [r.to_record() for r in store.replay(5)] == [want[2].to_record()]
    manifest = store.manifest()
    assert sorted(manifest) == [3, 5, 6] and manifest[6]["count"] == 3
    assert 'dataguard_replayed_total{source="stream-q"} 7' in reg.exposition()
    # a replayed epoch letters nothing twice, whichever package commits it
    assert store.commit_epoch(3, want[:2]) is False


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_a_torn_records_file_fails_its_crc_on_replay(tmp_path, pkg):
    _letter(PORT, str(tmp_path))
    path = tmp_path / "records" / "000005.jsonl"
    path.write_bytes(path.read_bytes().replace(b"schema", b"schemb"))
    store = pkg["dlq"].DeadLetterStore(str(tmp_path), registry=pkg["registry"].MetricsRegistry())
    with pytest.raises(ValueError, match="epoch 5 failed CRC"):
        store.replay(5)
    assert len(store.replay(3)) == 2


@pytest.mark.parametrize("writer,reader", [(tjournal, jjournal), (jjournal, tjournal)],
                         ids=["port_to_ref", "ref_to_port"])
def test_model_store_artifacts_read_across_packages(tmp_path, writer, reader):
    w = writer.ModelStore(str(tmp_path))
    assert w.commit("tree text", name="m") == 1
    payload = {"model": "m", "version": 1, "bins": 10, "features": {"x": {"n": 3}}}
    assert w.commit_artifact("m", 1, "quality", payload) == "m-000001.quality.json"
    r = reader.ModelStore(str(tmp_path))
    assert r.current_version("m") == 1 and r.current_version("other") is None
    assert r.read_artifact("m", 1, "quality") == payload
    assert r.read_artifact("m", 2, "quality") is None
    assert r.latest("m") == (1, "tree text")  # artifacts never move CURRENT
    with pytest.raises(ValueError, match="bare slug"):
        r.read_artifact("m", 1, "../x")
    path = tmp_path / "m-000001.quality.json"
    data = json.loads(path.read_text())
    data["bins"] = 11
    path.write_text(json.dumps(data, sort_keys=True))
    assert r.read_artifact("m", 1, "quality") is None  # torn: reads as missing


def test_artifact_files_are_the_references_bytes(tmp_path):
    payload = {"b": [1.5, None], "a": {"z": "1/3", "y": 2}}
    for mod, sub in ((tjournal, "port"), (jjournal, "ref")):
        mod.ModelStore(str(tmp_path / sub)).commit_artifact("model", 7, "quality", payload)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
