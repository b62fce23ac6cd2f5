"""The port's result re-scoring against the JAX package on the CPU:
eval/aggregate.py (load_result_file on .pkl and reference-format .pth,
aggregate_metrics with rot_outlier_ignore and sample_keys,
collect_eval_results with a cross-view file), cli/eval_saved_result.py in
both of its modes against the JAX CLI's printed tables, cli/evaluate_all.py
(evaluate_all.sh's counterpart), and the optimize CLI's --cross_eval_folder
resume."""
import json
import os
import pickle

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.cli import eval_saved_result as jax_cli
from supnerf_tpu.eval import aggregate as jax_agg
from supnerf_tpu_torch.cli import eval_saved_result, evaluate_all, optimize
from supnerf_tpu_torch.eval import aggregate

AGG_KEYS = ("psnr", "depth_err", "rot_err_deg", "trans_err")


def _result(seed, n=3, T=100, reference=False):
    """A result dict of the drivers' schema; with reference, the
    reference's .pth containers (R/T errors as lists of 0-d tensors,
    codes as tensors; optimizer_nuscenes.py:1463-1476)."""
    rng = np.random.default_rng(seed)
    keys = [f"ann{i}_CAM" for i in range(n)]
    rot = {k: rng.uniform(0, np.pi, T) for k in keys}
    rot[keys[0]][5:] = np.pi * 0.95        # a flipped car for rot_outlier_ignore
    res = {
        "num_obj": n,
        "psnr_eval": {k: rng.uniform(5, 20, T).tolist() for k in keys},
        "R_eval": rot,
        "T_eval": {k: rng.uniform(0, 2, T) for k in keys},
        "depth_err_mean": {k: rng.uniform(0, 2, T).tolist() for k in keys},
        "lidar_pts_cnt": {k: int(rng.integers(1, 80)) for k in keys},
        "optimized_shapecodes": {"x": {"CAM": rng.normal(size=(6, 8)).astype(np.float32)}},
    }
    res["psnr_eval"][keys[1]][7] = -3.0     # clipped to 0, as the reference does
    if reference:
        res["R_eval"] = {k: [torch.tensor(v) for v in r] for k, r in res["R_eval"].items()}
        res["T_eval"] = {k: [torch.tensor(v) for v in r] for k, r in res["T_eval"].items()}
        res["optimized_shapecodes"] = {"x": {"CAM": torch.from_numpy(
            res["optimized_shapecodes"]["x"]["CAM"])}}
    else:
        res["R_eval"] = {k: v.tolist() for k, v in res["R_eval"].items()}
        res["T_eval"] = {k: v.tolist() for k, v in res["T_eval"].items()}
    return res


def _cross(seed, iters=(0, 5, 10, 20, 50, 100)):
    rng = np.random.default_rng(seed)
    mats = {f"ins_{i}": [rng.uniform(5, 20, (n, n)) for _ in iters]
            for i, n in enumerate((1, 2, 3))}
    depth = {ins: [rng.uniform(0, 2, m.shape) for m in v] for ins, v in mats.items()}
    return {"psnr_eval_mat_per_ins": mats, "depth_eval_mat_per_ins": depth,
            "cnt_lidar_pts_per_ins": {}, "CODE_SAVE_ITERS_": list(iters)}


@pytest.fixture
def files(tmp_path):
    """codes+poses.pkl, a reference-style codes+poses.pth and cross_eval.pkl."""
    paths = {"pkl": str(tmp_path / "codes+poses.pkl"), "pth": str(tmp_path / "codes+poses.pth"),
             "cross": str(tmp_path / "cross_eval.pkl")}
    with open(paths["pkl"], "wb") as f:
        pickle.dump(_result(0), f)
    torch.save(_result(1, reference=True), paths["pth"])
    with open(paths["cross"], "wb") as f:
        pickle.dump(_cross(2), f)
    return paths


def _assert_same_agg(ours, ref):
    assert set(ours) == set(ref)
    assert ours["n_objects"] == ref["n_objects"]
    for k in AGG_KEYS:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-6, rtol=1e-6, err_msg=k)
    if "cross" in ref:
        for k in ("iters", "psnr_cross", "depth_cross"):
            np.testing.assert_allclose(ours["cross"][k], ref["cross"][k], atol=1e-6, err_msg=k)


def test_load_reference_style_pth(files):
    """JAX tests/test_eval_interop.py test_load_reference_style_pth: a
    reference-format .pth loads with numpy leaves and aggregates."""
    result = aggregate.load_result_file(files["pth"])
    assert isinstance(result["optimized_shapecodes"]["x"]["CAM"], np.ndarray)
    assert isinstance(result["R_eval"]["ann0_CAM"][0], np.ndarray)
    agg = aggregate.aggregate_metrics(result, max_iter=100)
    assert agg["psnr"].shape == (100,)
    assert all(np.isfinite(agg[k]).all() for k in AGG_KEYS)
    _assert_same_agg(agg, jax_agg.aggregate_metrics(jax_agg.load_result_file(files["pth"]), 100))


@pytest.mark.parametrize("kind", ["pkl", "pth"])
@pytest.mark.parametrize("options", [{}, {"rot_outlier_ignore": True},
                                     {"sample_keys": ["ann2_CAM", "ann0_CAM"], "max_iter": 50}])
def test_collect_eval_results_matches_jax(files, capsys, kind, options):
    """The same aggregates (1e-6) and the same printed table as the JAX
    collect_eval_results, the cross-view rows included."""
    ours = aggregate.collect_eval_results(files[kind], cross_eval_file=files["cross"], **options)
    printed = capsys.readouterr().out
    ref = jax_agg.collect_eval_results(files[kind], cross_eval_file=files["cross"], **options)
    assert printed == capsys.readouterr().out
    _assert_same_agg(ours, ref)
    if options.get("rot_outlier_ignore"):
        plain = aggregate.collect_eval_results(files[kind])
        assert (ours["rot_err_deg"][1:] <= plain["rot_err_deg"][1:]).all()
        assert (ours["rot_err_deg"][5:] < plain["rot_err_deg"][5:]).all()
        assert ours["rot_err_deg"][0] == plain["rot_err_deg"][0]


def _table(out):
    return [line for line in out.splitlines() if not line.startswith("saved ")]


def test_eval_saved_result_explicit_files_match_jax_cli(files, tmp_path, capsys):
    """Explicit files with --cross_eval, --max_iter and --rot_outlier_ignore:
    the JAX CLI's printed tables, and eval.json holding each file's four
    curves (its aggregate) and cross-view points under the panel names."""
    args = [files["pkl"], files["pth"], "--cross_eval", files["cross"], "--max_iter", "60",
            "--rot_outlier_ignore"]
    summary = eval_saved_result.main(args + ["--out", str(tmp_path / "eval.json")])
    ours = capsys.readouterr().out
    jax_cli.main(args + ["--out", str(tmp_path / "eval.pdf")])
    assert _table(ours) == _table(capsys.readouterr().out)
    data = json.loads((tmp_path / "eval.json").read_text())
    assert data["panels"] == ["PSNR", "Depth Err", "Rot Err", "Trans Err"]
    assert [r["file"] for r in data["results"]] == [files["pkl"], files["pth"]]
    assert [r["color"] for r in data["results"]] == ["b", "r"]
    for entry, path, agg in zip(data["results"], (files["pkl"], files["pth"]),
                                summary["aggregates"]):
        ref = jax_agg.collect_eval_results(path, max_iter=60, cross_eval_file=files["cross"],
                                           rot_outlier_ignore=True)
        _assert_same_agg(agg, ref)
        for panel, key in zip(data["panels"], AGG_KEYS):
            np.testing.assert_allclose(entry["curves"][panel], ref[key], atol=1e-6)
        np.testing.assert_allclose(entry["cross_view"]["PSNR"]["values"],
                                   ref["cross"]["psnr_cross"], atol=1e-6)
        assert entry["cross_view"]["Depth Err"]["iters"] == [0, 5, 10, 20, 50, 100]


def test_eval_saved_result_folder_mode_and_pdf_refusal(files, tmp_path, capsys):
    """The reference folder convention: codes+poses and cross_eval found in
    MODEL/TEST, the table under the legend banner as the JAX CLI prints it,
    LEGEND.json in --save-dir; a .pdf --out is refused with its reason."""
    folder = os.path.dirname(files["pkl"])
    args = ["--model-folder", os.path.dirname(folder), "--test-folder", os.path.basename(folder),
            "--legend-name", "SUPNeRF", "--plot-cross-view"]
    summary = eval_saved_result.main(args + ["--save-dir", str(tmp_path / "ours")])
    ours = capsys.readouterr().out
    jax_cli.main(args + ["--save-dir", str(tmp_path / "jax")])
    assert _table(ours) == _table(capsys.readouterr().out)
    assert "Evaluating SUPNeRF" in ours and "psnr cross-view" in ours
    assert summary["out"] == str(tmp_path / "ours" / "SUPNeRF.json")
    assert json.loads((tmp_path / "ours" / "SUPNeRF.json").read_text())["results"][0]["legend"] \
        == "SUPNeRF"
    with pytest.raises(ValueError, match="JSON"):
        eval_saved_result.main([files["pkl"], "--out", str(tmp_path / "eval.pdf")])


def test_evaluate_all_walks_a_tree(tmp_path, capsys):
    """Every codes+poses.pkl under ROOT, in sorted order, with its folder's
    cross_eval.pkl where there is one: eval.json beside each, and the tables
    eval_saved_result prints for the same arguments."""
    for name, cross in (("b_run", True), ("a_run", False)):
        d = tmp_path / "ckpt" / name
        d.mkdir(parents=True)
        with open(d / "codes+poses.pkl", "wb") as f:
            pickle.dump(_result(len(name) + cross), f)
        if cross:
            with open(d / "cross_eval.pkl", "wb") as f:
                pickle.dump(_cross(5), f)
    done = evaluate_all.main([str(tmp_path / "ckpt")])
    printed = capsys.readouterr().out
    a, b = (str(tmp_path / "ckpt" / n / "codes+poses.pkl") for n in ("a_run", "b_run"))
    assert list(done) == [a, b]
    assert "cross" in done[b]["aggregates"][0] and "cross" not in done[a]["aggregates"][0]
    for path in (a, b):
        assert os.path.exists(os.path.join(os.path.dirname(path), "eval.json"))
    eval_saved_result.main([a, "--out", str(tmp_path / "a.json")])
    eval_saved_result.main([b, "--cross_eval", b.replace("codes+poses", "cross_eval"),
                            "--out", str(tmp_path / "b.json")])
    assert _table(printed) == _table(capsys.readouterr().out)


def test_cross_eval_folder_resumes_evaluation(tmp_path):
    """--cross_eval_folder: no optimization, the folder's codes re-rendered
    into every view; the report and cross-view means equal the run's own."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({
        "arch": "supnerf", "net_hyperparams": {"shape_blocks": 1, "texture_blocks": 1,
                                               "latent_dim": 32, "pose_shortcut": 1,
                                               "pred_wlh": 0},
        "render_im_sz": 8, "n_samples": 8, "in_img_sz": 32, "optimize": {"num_opts": 6},
        "model_dir": str(tmp_path / "no_checkpoint")}))
    common = ["--config_file", str(cfg), "--dataset", "synthetic", "--num_objects", "2",
              "--device", "cpu"]
    run = optimize.main(common + ["--save_dir", str(tmp_path / "run"), "--code_level", "1"])
    again = optimize.main(common + ["--cross_eval_folder", str(tmp_path / "run")])
    assert again["save_dir"] == str(tmp_path / "run") and again["loss"] == {}
    assert "tto_loop" not in again["phase_seconds"]
    for k in AGG_KEYS:
        np.testing.assert_array_equal(again["aggregate"][k], run["aggregate"][k])
    np.testing.assert_allclose(again["cross"]["psnr_cross"], run["cross"]["psnr_cross"],
                               atol=1e-5)
    data = json.loads((tmp_path / "run" / "eval.json").read_text())
    assert set(data["results"][0]["curves"]) == set(data["panels"])
