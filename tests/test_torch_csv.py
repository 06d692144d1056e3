"""The port's CSV path (``data/csv.py``, its own ``data/native`` fastcsv,
``Dataset.from_csv`` / ``from_spark``) against the JAX package's.

The matrices must be equal bit for bit (both parse with the same
``strtof`` code, the port's built from its own copy of the source); the
numpy fallback, forced by taking the native library away, must equal
the native reader where both parse and warn once; ``from_spark``'s shim
cases are ``tests/test_data.py``'s, on both packages."""

import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from dist_keras_tpu.data import csv as jcsv
from dist_keras_tpu.data.dataset import Dataset as JDataset
from dist_keras_tpu_torch.data import csv as tcsv
from dist_keras_tpu_torch.data import native as tnative
from dist_keras_tpu_torch.data.dataset import Dataset as TDataset

ROOT = Path(__file__).resolve().parent.parent
SAMPLES = [ROOT / "examples" / "data" / "mnist_sample.csv",
           ROOT / "examples" / "data" / "higgs_sample.csv"]

# tests/test_data.py's blank-line cases, plus ragged rows (a short row
# fills 0 on the native path, extra fields are dropped)
BLANK_CASES = {
    "a,b\n1,2\n3,4\n\n": [[1, 2], [3, 4]],
    "a,b\n1,2\n3,4\n\n\n": [[1, 2], [3, 4]],
    "a,b\n1,2\n\n3,4\n5,6\n": [[1, 2], [3, 4], [5, 6]],
    "a,b\r\n1,2\r\n\r\n3,4\r\n": [[1, 2], [3, 4]],
    "a,b\n1,2\n   \n3,4\n": [[1, 2], [3, 4]],
    "a,b\n1,2\n3,4": [[1, 2], [3, 4]],
}
RAGGED_CASES_LONG = "a,b\n1,2\n3,4,5\n"
RAGGED_CASES = {
    "a,b,c\n1,2,3\n4,5\n": [[1, 2, 3], [4, 5, 0]],
    RAGGED_CASES_LONG: [[1, 2], [3, 4]],
}


def _write(tmp_path, name, content):
    p = tmp_path / name
    p.write_text(content)
    return str(p)


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", SAMPLES, ids=lambda p: p.name)
def test_read_numeric_csv_equals_jax(path):
    tm, tn = tcsv.read_numeric_csv(str(path))
    jm, jn = jcsv.read_numeric_csv(str(path))
    assert tn == jn
    _equal(tm, jm)


@pytest.mark.parametrize("path", SAMPLES, ids=lambda p: p.name)
def test_read_csv_and_from_csv_equal_jax(path):
    for tds, jds in ((tcsv.read_csv(str(path)), jcsv.read_csv(str(path))),
                     (TDataset.from_csv(str(path), label="label"),
                      JDataset.from_csv(str(path), label="label"))):
        assert tds.columns == jds.columns
        for c in tds.columns:
            _equal(tds[c], jds[c])


@pytest.mark.parametrize("path", SAMPLES, ids=lambda p: p.name)
def test_headerless_file_equals_jax(tmp_path, path):
    body = Path(path).read_text().split("\n", 1)[1]
    p = _write(tmp_path, "noheader.csv", body)
    tm, tn = tcsv.read_numeric_csv(p, has_header=False)
    jm, jn = jcsv.read_numeric_csv(p, has_header=False)
    assert tn == jn == [f"c{i}" for i in range(tm.shape[1])]
    _equal(tm, jm)
    tds = tcsv.read_csv(p, has_header=False)
    jds = jcsv.read_csv(p, has_header=False)
    for c in ("features", "label"):
        _equal(tds[c], jds[c])


@pytest.mark.parametrize("content", list(BLANK_CASES) + list(RAGGED_CASES),
                         ids=lambda c: repr(c)[:24])
def test_blank_lines_and_ragged_rows(tmp_path, content):
    want = {**BLANK_CASES, **RAGGED_CASES}[content]
    p = _write(tmp_path, "case.csv", content)
    got, _ = tcsv.read_numeric_csv(p)
    assert got.tolist() == want
    _equal(got, jcsv.read_numeric_csv(p)[0])


def test_library_builds_from_the_port_source_into_its_own_dir(tmp_path,
                                                              monkeypatch):
    port_build = ROOT / "dist_keras_tpu_torch" / "_build"
    assert tnative.library_path().parent == port_build
    assert tnative._SRC == (ROOT / "dist_keras_tpu_torch" / "data" /
                            "native" / "fastcsv.cpp")
    lib = tnative.load_fastcsv()
    assert lib is not None
    assert Path(lib._name).parent == port_build
    assert Path(lib._name).name.startswith("libfastcsv-")
    # a fresh build lands where BUILD_DIR points, never in the JAX dir
    jax_dir = ROOT / "dist_keras_tpu" / "data" / "native"
    before = sorted(os.listdir(jax_dir))
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "b")
    so = tnative.build_fastcsv(force=True)
    assert so is not None and so.parent == tmp_path / "b" and so.exists()
    assert sorted(os.listdir(jax_dir)) == before
    # the name is keyed by the source: another source, another library
    monkeypatch.setattr(tnative, "_SRC", tmp_path / "other.cpp")
    (tmp_path / "other.cpp").write_text("// another source\n")
    assert tnative.library_path() != so


def test_numpy_fallback_equals_native_and_warns_once(tmp_path, monkeypatch,
                                                     capsys):
    native = {str(p): tcsv.read_numeric_csv(str(p)) for p in SAMPLES}
    cases = {}
    for i, content in enumerate(BLANK_CASES):
        p = _write(tmp_path, f"blank{i}.csv", content)
        cases[p] = tcsv.read_numeric_csv(p)
    capsys.readouterr()
    monkeypatch.setattr(tcsv, "_native_lib", lambda: None)
    monkeypatch.setattr(tcsv, "_native_warned", False)
    for path, (want, names) in {**native, **cases}.items():
        got, got_names = tcsv.read_numeric_csv(path)
        assert got_names == names
        _equal(got, want)
    err = capsys.readouterr().err
    assert err.count("WARNING: native CSV reader") == 1
    assert "falling back to numpy" in err


def test_fallback_after_a_native_failure_warns_with_the_error(
        tmp_path, monkeypatch, capsys):
    p = _write(tmp_path, "t.csv", "a,b\n1,2\n")

    def broken(*a, **k):
        raise IOError("planted")

    monkeypatch.setattr(tcsv, "_read_native", broken)
    monkeypatch.setattr(tcsv, "_native_warned", False)
    got, _ = tcsv.read_numeric_csv(p)
    assert got.tolist() == [[1, 2]]
    err = capsys.readouterr().err
    assert "failed (OSError('planted'))" in err


def test_fallback_reads_blank_fields_as_pandas_does(tmp_path, monkeypatch):
    """An empty field is NaN and a short row is padded with NaN, as the
    JAX package's pandas fallback makes them; a row longer than the
    header is cut to it, as the native reader cuts it."""
    p = _write(tmp_path, "t.csv", "a,b,c\n1,,3\n4,5\n,,\n7,8,9\n")
    monkeypatch.setattr(tcsv, "_native_lib", lambda: None)
    monkeypatch.setattr(tcsv, "_native_warned", True)
    got, names = tcsv.read_numeric_csv(p)
    want = pd.read_csv(p).to_numpy(dtype=np.float32)
    assert names == ["a", "b", "c"]
    np.testing.assert_array_equal(got, want)   # NaNs in the same places
    long = _write(tmp_path, "long.csv", RAGGED_CASES_LONG)
    assert tcsv.read_numeric_csv(long)[0].tolist() == \
        RAGGED_CASES[RAGGED_CASES_LONG]


# -- from_spark: tests/test_data.py's shim cases, on both packages --------

class _FakeSparkDF:
    def toPandas(self):
        return pd.DataFrame({
            "features": [np.arange(4, dtype=np.float32) + i
                         for i in range(6)],
            "label": np.arange(6) % 2,
        })


class _RaggedSDF:
    def toPandas(self):
        return pd.DataFrame({"feats": [np.zeros(3), np.zeros(4)]})


class _NullSDF:
    def toPandas(self):
        return pd.DataFrame({"feats": pd.Series([None, None],
                                                dtype=object)})


class _EmptySDF:
    def toPandas(self):
        return pd.DataFrame({"feats": []})


class _NoPandasSDF:
    def toPandas(self):
        raise ImportError("No module named 'pandas'")


def test_from_spark_pandas_bridge_equals_jax():
    tds, jds = (TDataset.from_spark(_FakeSparkDF()),
                JDataset.from_spark(_FakeSparkDF()))
    assert tds["features"].shape == (6, 4)
    assert tds["features"].dtype == np.float32
    assert tds.columns == jds.columns
    for c in tds.columns:
        _equal(tds[c], jds[c])


@pytest.mark.parametrize("sdf,exc,match", [
    ({"not": "a spark df"}, TypeError, "toPandas"),
    (_RaggedSDF(), ValueError, "'feats'"),
    (_NullSDF(), ValueError, "'feats'"),
    (_EmptySDF(), ValueError, "0 rows")],
    ids=["not_a_dataframe", "ragged", "all_null", "empty"])
def test_from_spark_refusals_equal_jax(sdf, exc, match):
    for cls in (TDataset, JDataset):
        with pytest.raises(exc, match=match):
            cls.from_spark(sdf)


def test_from_spark_without_pandas_says_so():
    with pytest.raises(ImportError, match="needs pandas") as e:
        TDataset.from_spark(_NoPandasSDF())
    assert isinstance(e.value.__cause__, ImportError)
