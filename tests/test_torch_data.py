"""The port's data path and checkpoints against the JAX package on the
CPU:

- the ``SFRS0001`` record shards: the JAX package's writer read by the
  port, the port's writer read by the JAX package's native (g++) and
  pure-Python readers, byte for byte;
- ``ODERegressionDataset``, ``ShardingDataset`` (a stray file skipped)
  and ``PoseShardingDataset`` items equal to the JAX package's;
- ``DistributedSampler``'s order equal to the JAX package's for the same
  seed, epoch and replica count (the pad longer than the data included),
  and one replica of rank 0 when no process group exists;
- the prefetching ``DataLoader``: the JAX loader's batches, and a
  worker's exception raised in the consumer;
- ``save_pytree`` / ``restore_pytree``: dtypes, devices and a template
  that does not fit;
- ``save_reference_checkpoint`` read back through the JAX package's
  ``load_torch_state_dict(path, 'generator')`` + ``convert_dit_state_dict``
  into the source parameters.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu.data import datasets as jds
from self_forcing_tpu.data import loader as jloader
from self_forcing_tpu.data import recordstore as jrs
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.utils import checkpoints as jckpt
from self_forcing_tpu_torch.data import datasets as tds
from self_forcing_tpu_torch.data import loader as tloader
from self_forcing_tpu_torch.data import recordstore as trs
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
from self_forcing_tpu_torch.utils import checkpoints as tckpt
from self_forcing_tpu_torch.utils import tree


def _write(rs, path, arrays, shapes):
    with rs.RecordWriter(path) as w:
        rs.store_arrays(w, arrays)
        for name, shape in shapes.items():
            rs.write_shape_header(w, name, shape)
        w.put("odd_key", b"\x01\x02\x03")   # an unaligned record


def _arrays(seed, rows=3, shape=(2, 3, 4, 4)):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((rows, *shape)).astype(np.float16)
    return {"latents": lat,
            "prompts": [f"prompt {seed} {i} é" for i in range(rows)]}, \
        {"latents": lat.shape}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_record_shards_cross_read(tmp_path, direction):
    """Every record's bytes and every row agree across the two packages'
    writers and readers (the JAX native reader and its Python one)."""
    arrays, shapes = _arrays(1)
    path = str(tmp_path / "s.rs")
    writer = jrs if direction == "jax_to_port" else trs
    _write(writer, path, arrays, shapes)
    readers = ([trs.RecordReader(path)] if direction == "jax_to_port"
               else [jrs.RecordReader(path), jrs._PyReader(path)])
    if direction == "port_to_jax":
        assert readers[0]._py is None, "the JAX native reader did not load"
    ref = (jrs._PyReader(path) if direction == "jax_to_port"
           else trs.RecordReader(path))
    for r in readers:
        assert len(r) == len(ref) == 3 * 2 + 2
        assert sorted(r.keys()) == sorted(ref.keys())
        for k in ref.keys():
            assert bytes(r.get(k)) == bytes(ref.get(k)), k
        assert r.get(b"missing") is None
    shape = trs.get_array_shape(trs.RecordReader(path), "latents")
    assert shape == arrays["latents"].shape
    for i in range(3):
        np.testing.assert_array_equal(
            trs.retrieve_row(trs.RecordReader(path), "latents", np.float16,
                             i, shape[1:]), arrays["latents"][i])
        assert trs.retrieve_row(trs.RecordReader(path), "prompts", str,
                                i) == arrays["prompts"][i]


def test_port_reader_views_and_errors(tmp_path):
    """A record view outlives its reader's close; a missing shape or row
    and a file that is not a shard raise."""
    arrays, shapes = _arrays(2)
    path = str(tmp_path / "s.rs")
    _write(trs, path, arrays, shapes)
    r = trs.RecordReader(path)
    view = r.get("latents_0_data")
    r.close()
    assert not view.flags.writeable
    np.testing.assert_array_equal(np.frombuffer(bytes(view), np.float16),
                                  arrays["latents"][0].reshape(-1))
    r = trs.RecordReader(path)
    with pytest.raises(KeyError):
        trs.get_array_shape(r, "dwpose_data")
    with pytest.raises(KeyError):
        trs.retrieve_row(r, "latents", np.float16, 9)
    bad = tmp_path / "bad.rs"
    bad.write_bytes(b"NOTSHARD" + b"\0" * 32)
    with pytest.raises(ValueError, match="SFRS0001"):
        trs.RecordReader(str(bad))


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kind", ["ode", "sharding", "pose"])
def test_datasets_match_jax(tmp_path, kind):
    """Items of the port's datasets on shards the port wrote equal the JAX
    package's datasets' items on the same files."""
    if kind == "ode":
        arrays, shapes = _arrays(3, rows=2, shape=(5, 3, 4, 4, 2))
        path = str(tmp_path / "ode.rs")
        _write(trs, path, arrays, shapes)
        pairs = (tds.ODERegressionDataset(path),
                 jds.ODERegressionDataset(path))
    else:
        d = tmp_path / "shards"
        d.mkdir()
        rng = np.random.default_rng(4)
        for s in range(2):
            arrays, shapes = _arrays(10 + s, rows=2 + s)
            if kind == "pose":
                arrays["dwpose_data"] = rng.integers(
                    0, 255, (2 + s, 3, 2, 8, 6), dtype=np.uint8)
                shapes["dwpose_data"] = arrays["dwpose_data"].shape
                if s == 0:
                    arrays["first_frame"] = rng.integers(
                        0, 255, (2, 8, 6, 3), dtype=np.uint8)
                    shapes["first_frame"] = arrays["first_frame"].shape
            _write(trs, str(d / f"shard{s}.rs"), arrays, shapes)
        (d / "notes.txt").write_text("not a shard")
        cls_t, cls_j = ((tds.PoseShardingDataset, jds.PoseShardingDataset)
                        if kind == "pose" else
                        (tds.ShardingDataset, jds.ShardingDataset))
        pairs = (cls_t(str(d)), cls_j(str(d)))
    ds_t, ds_j = pairs
    assert len(ds_t) == len(ds_j) == (2 if kind == "ode" else 5)
    for i in range(len(ds_j)):
        _assert_items_equal(ds_t[i], ds_j[i])
    if kind == "pose":
        assert "first_frame" in ds_t[0] and "first_frame" not in ds_t[4]


@pytest.mark.parametrize("n,replicas,shuffle,epoch", [
    (10, 1, True, 0), (10, 3, True, 2), (7, 4, False, 0), (2, 5, True, 1)])
def test_distributed_sampler_matches_jax(n, replicas, shuffle, epoch):
    """Each rank's indices equal the JAX sampler's, the pad (longer than
    the data for n=2 over 5 replicas) included."""
    for rank in range(replicas):
        st = tloader.DistributedSampler(n, replicas, rank, shuffle, seed=7)
        sj = jloader.DistributedSampler(n, replicas, rank, shuffle, seed=7)
        st.set_epoch(epoch)
        sj.set_epoch(epoch)
        assert list(st) == list(sj)
        assert len(st) == len(sj)
    default = tloader.DistributedSampler(n)
    assert (default.num_replicas, default.rank) == (1, 0)


class _Rows:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise RuntimeError(f"corrupt row {i}")
        return {"x": np.full((2,), i, np.float32), "name": f"row {i}"}


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_batches_match_jax(drop_last):
    sampler = dict(num_replicas=1, rank=0, seed=3)
    bt = list(tloader.DataLoader(
        _Rows(7), 3, tloader.DistributedSampler(7, **sampler),
        drop_last=drop_last))
    bj = list(jloader.DataLoader(
        _Rows(7), 3, jloader.DistributedSampler(7, **sampler),
        drop_last=drop_last))
    assert len(bt) == len(bj) == (2 if drop_last else 3)
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a["x"], b["x"])
        assert a["name"] == b["name"]


def test_dataloader_worker_error_reaches_consumer():
    """The worker's exception is raised by the iteration, and leaving an
    infinite iteration early stops the worker thread."""
    loader = tloader.DataLoader(_Rows(6, fail_at=4), 2, tloader.
                                DistributedSampler(6, 1, 0, shuffle=False))
    got = []
    with pytest.raises(RuntimeError, match="corrupt row 4"):
        for b in loader:
            got.append(b)
    assert len(got) == 2
    before = threading.active_count()
    it = iter(tloader.DataLoader(_Rows(4), 2, infinite=True, prefetch=1))
    assert next(it)["x"].shape == (2, 2)
    it.close()
    assert threading.active_count() <= before


def test_save_restore_pytree(tmp_path):
    """A tree of tensors (bf16 and float32), lists, ints and None comes
    back equal, cast and placed as the template's leaves; a template of
    another structure or shape raises."""
    params = tdit.init_params(WAN_TINY, 0, torch.bfloat16, "cpu")
    state = {"params": params,
             "opt": {"count": 3, "mu": [torch.randn(4), None]},
             "ema": None, "step": 5}
    path = str(tmp_path / "sub" / "state.pt")
    tckpt.save_pytree(path, state)
    like = {"params": tree.map_tree(lambda t: torch.zeros_like(
        t, dtype=torch.float32), params),
        "opt": {"count": 0, "mu": [torch.zeros(4), None]},
        "ema": None, "step": 0}
    back = tckpt.restore_pytree(path, like)
    assert back["step"] == 5 and back["opt"]["count"] == 3
    assert back["ema"] is None and back["opt"]["mu"][1] is None
    torch.testing.assert_close(back["opt"]["mu"][0], state["opt"]["mu"][0])
    for (p, a), b in zip(tree.items(back["params"]), tree.leaves(params)):
        assert a.dtype == torch.float32, p
        assert torch.equal(a, b.float()), p
    raw = tckpt.restore_pytree(path)
    assert tree.leaves(raw["params"])[0].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="template"):
        tckpt.restore_pytree(path, {**like, "extra": 1})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_pytree(path, {**like, "opt": {
            "count": 0, "mu": [torch.zeros(5), None]}})


def test_save_reference_checkpoint_loads_in_jax(tmp_path):
    """A generator and its EMA saved in the reference's layout load
    through the JAX package's loader and converter into the source
    parameters (bf16 on disk: equal to the bf16-rounded source)."""
    gen = tdit.init_params(WAN_TINY, 1, torch.float32, "cpu")
    ema = tdit.init_params(WAN_TINY, 2, torch.float32, "cpu")
    path = str(tmp_path / "self_forcing.pt")
    tckpt.save_reference_checkpoint(path, {"generator": gen,
                                           "generator_ema": ema},
                                    WAN_TINY, dtype=torch.bfloat16)
    for key, src in (("generator", gen), ("generator_ema", ema)):
        sd = jckpt.load_torch_state_dict(path, key)
        conv = jckpt.convert_dit_state_dict(sd, J_TINY, dtype=jnp.float32)
        shape_j = jax.eval_shape(lambda: jdit.init_params(
            jax.random.PRNGKey(0), J_TINY, dtype=jnp.float32))
        assert jax.tree.structure(conv) == jax.tree.structure(shape_j)
        flat = {tuple(getattr(k, "key", k) for k in path_): np.asarray(v)
                for path_, v in jax.tree_util.tree_flatten_with_path(conv)[0]}
        for p, a in tree.items(src):
            want = a.to(torch.bfloat16).float().numpy()
            np.testing.assert_array_equal(flat[p], want, err_msg=str(p))
