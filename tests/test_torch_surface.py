"""The port's public surface against the JAX package's, read with `ast` (no
JAX import): every public top-level name and public method of every JAX
module exists in the port module at the same path (the Pallas files map to
the modules that hold their CUDA kernels), or under another name listed in
RENAMED (whose target must exist), or in NO_COUNTERPART with the reason it
has none. Every name a JAX `__init__` exports imports from the port's
`__init__`, or is listed the same way. Neither table may go stale, and
NO_COUNTERPART holds only names of the JAX stack (XLA, jit, Pallas,
jax.sharding, flax), never a CLI, a native helper or a model function.
Every parameter of a JAX function or method (`__init__` included) that has
a counterpart is a parameter of that counterpart, or is listed in
PARAM_RENAMED or PARAM_NO_COUNTERPART the same way."""
import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "spatially_aware_ai_tpu")
PORT_PKG = os.path.join(ROOT, "spatially_aware_ai_tpu_torch")

# JAX module (relative path) -> the port module that holds its counterpart
MIRROR = {
    "grid/pallas_fusion.py": "grid/splat.py",
    "grid/pallas_tiledma.py": "grid/tiledma.py",
    "models/pallas_mlp.py": "models/ln_mlp.py",
    "models/kmax/pallas_paint.py": "models/kmax/paint.py",
}

# JAX name -> the port's name for the same function
RENAMED = {
    "grid/pallas_fusion.py::fused_feature_splat": "grid/splat.py::splat",
    "grid/fusion.py::einsum_feature_splat": "grid/splat.py::splat",
    "models/clip/model.py::PatchifyConv":
        "models/clip/model.py::VisionTower.patchify",
    "models/clip/model.py::ResidualBlock":
        "models/clip/model.py::ResidualAttentionBlock",
    "models/clip/model.py::TextTower":
        "models/clip/model.py::CLIP.encode_text",
}

_JIT_BODY = ("the jitted / shard_map body behind the public integrator; "
             "the port's integrator is that body")
_FLAX_SETUP = ("flax's module-construction hook; torch modules build in "
               "__init__")
_SLOTS = ("static-shape slot budget that keeps XLA's shapes fixed; the port "
          "compacts to the exact count")
NO_COUNTERPART = {
    "pipeline.py::AdaptiveCap": _SLOTS,
    "pipeline.py::AdaptiveCap.for_brick": _SLOTS,
    "pipeline.py::AdaptiveCap.for_sparse": _SLOTS,
    "pipeline.py::AdaptiveCap.observe": _SLOTS,
    "pipeline.py::sharded_grid_bucket":
        "rounds XLA's flat buffer for the Pallas tile per shard; the port's "
        "shards take any row count",
    "parallel/mesh.py::grid_sharding":
        "a jax.sharding NamedSharding spec; DeviceMesh places the shards",
    "parallel/mesh.py::frame_sharding":
        "a jax.sharding NamedSharding spec; DeviceMesh splits the frames",
    "models/attention.py::attention_mode":
        "picks one of two XLA einsum layouts (SAI_ATTN); the port's "
        "attention is kernel B5",
    "models/pallas_mlp.py::DEFAULT_TM": "a Pallas VMEM row tile",
    "models/pallas_mlp.py::DEFAULT_TH": "a Pallas VMEM hidden tile",
    "models/pallas_mlp.py::use_fused_mlp":
        "chooses Pallas or XLA per call site; the port's blocks always run "
        "kernel B2",
    "models/clip/model.py::CLIP.setup": _FLAX_SETUP,
    "models/clip/model.py::VisionTower.setup": _FLAX_SETUP,
    "models/kmax/model.py::KMaxPredictor.setup": _FLAX_SETUP,
    "models/kmax/convnext.py::dwconv7_shift":
        "the depthwise 7x7 conv as 49 shifted slices for XLA's fusion; the "
        "port's is one grouped convolution",
    "models/kmax/convnext.py::use_shift_dwconv":
        "the SAI_DWCONV gate of dwconv7_shift",
    "grid/brick.py::integrate_frames_brick_impl": _JIT_BODY,
    "grid/fusion.py::integrate_frames_impl": _JIT_BODY,
    "grid/fusion.py::integrate_frames_hybrid_impl": _JIT_BODY,
    "grid/fusion.py::integrate_frames_sparse_impl": _JIT_BODY,
    "grid/pallas_fusion.py::DEFAULT_TILE": "a Pallas voxel tile",
    "utils/cache.py::enable_compilation_cache":
        "XLA's persistent compilation cache",
    "meshing/extract.py::VERT_BUCKET":
        "a jit shape bucket for the vertex samplers",
    "meshing/extract.py::FLAT_BUCKET":
        "a jit shape bucket for the flat voxel buffers",
    "meshing/extract.py::warm_vertex_samplers":
        "compiles the jitted vertex samplers ahead of the first mesh",
}

# "module::function(parameter)" of the JAX package -> the port's name for
# the same parameter
PARAM_RENAMED = {
    "core/upsample.py::upsample_depth_u16_device(depth_u16)": "depth",
    "grid/fusion.py::blocked_label_splat(valids)": "votes",
    "models/clip/engine.py::ClipEngine.__init__(params)": "state_dict",
    "models/kmax/model.py::KmaxSegmenter.__init__(params)": "state_dict",
    "models/clip/engine.py::ClipEngine.img_inference_tiled_depthscaled(img)":
        "imgs",
    "models/clip/tiling.py::tiled_image_features_depthscaled(img)": "imgs",
    "pipeline.py::labels_for_chunk(rgb_chunk)": "rgb_host",
}

_INTERPRET = "runs a Pallas kernel in interpret mode off the TPU"
_PALLAS_TILE = "a Pallas VMEM tile size"
_CAPACITY = ("a static-shape slot budget for XLA; the port compacts to the "
             "exact count")
_AXIS = ("the jax.sharding mesh axis name; a DeviceMesh has one shard axis")
_XLA_BLOCK = ("the voxel block of an XLA lax.map that bounds a one-hot "
              "transient; the port adds votes in place")
_PARAMS = ("flax parameters passed to a pure function; the port's encode_fn "
           "closes over its module's weights")
# "module::function(parameter)" of the JAX package with no counterpart in
# the port, and why
PARAM_NO_COUNTERPART = {
    "grid/brick.py::integrate_frames_brick(capacity)": _CAPACITY,
    "grid/brick.py::integrate_frames_brick(brick_capacity)": _CAPACITY,
    "grid/fusion.py::integrate_frames_sparse(capacity)": _CAPACITY,
    "parallel/sharded.py::make_sharded_integrate(capacity)": _CAPACITY,
    "parallel/sharded.py::make_sharded_integrate(brick_capacity)": _CAPACITY,
    "grid/fusion.py::blocked_label_splat(block_voxels)": _XLA_BLOCK,
    "grid/fusion.py::einsum_feature_splat(block_voxels)": _XLA_BLOCK,
    "grid/fusion.py::integrate_frames_pallas(tile)": _PALLAS_TILE,
    "grid/fusion.py::integrate_frames_pallas(interpret)": _INTERPRET,
    "grid/pallas_fusion.py::fused_feature_splat(tile)": _PALLAS_TILE,
    "grid/pallas_fusion.py::fused_feature_splat(interpret)": _INTERPRET,
    "grid/pallas_tiledma.py::tile_sample_nearest(interpret)": _INTERPRET,
    "models/kmax/pallas_paint.py::paint_masks(interpret)": _INTERPRET,
    "models/pallas_mlp.py::fused_ln_mlp(tm)": _PALLAS_TILE,
    "models/pallas_mlp.py::fused_ln_mlp(th)": _PALLAS_TILE,
    "models/pallas_mlp.py::fused_ln_mlp(interpret)": _INTERPRET,
    "models/kmax/model.py::panoptic_inference_batch(use_pallas)":
        "chooses the Pallas paint or XLA's loop; the port's batch path "
        "always runs kernel B3",
    "models/kmax/model.py::panoptic_inference_batch(interpret)": _INTERPRET,
    "parallel/sharded.py::integrate_frames_sharded(use_pallas)":
        "chooses the Pallas splat or XLA's einsum; the port's integrators "
        "always run kernel B1",
    "parallel/sharded.py::integrate_frames_sharded(pallas_tile)":
        _PALLAS_TILE,
    "parallel/sharded.py::integrate_frames_sharded(pallas_interpret)":
        _INTERPRET,
    "parallel/sharded.py::make_sharded_integrate(pallas_tile)": _PALLAS_TILE,
    "parallel/sharded.py::make_sharded_integrate(pallas_interpret)":
        _INTERPRET,
    "parallel/mesh.py::make_mesh(axis)": _AXIS,
    "parallel/sharded.py::integrate_frames_sharded(axis)": _AXIS,
    "parallel/sharded.py::make_sharded_integrate(axis)": _AXIS,
    "parallel/sharded.py::make_sharded_fusion_step(axis)": _AXIS,
    "parallel/sharded.py::shard_grid(axis)": _AXIS,
    "parallel/sharded.py::make_sharded_fusion_step(encode_image_fn)":
        "a jitted flax encode for shard_map; the port takes the engine, "
        "one replica per device",
    "parallel/multihost.py::build_batch(jnp)":
        "the JAX module handed in so that the harness imports JAX late; "
        "the port takes the device",
    "parallel/multihost.py::build_batch(FrameBatch)":
        "the JAX FrameBatch class handed in with jnp; the port imports its "
        "own",
    "models/kmax/model.py::KmaxSegmenter.__init__(seed)":
        "draws flax random weights when params is None; the port's "
        "KmaxSegmenter.random(seed=) does",
    "models/clip/tiling.py::tiled_image_features(params)": _PARAMS,
    "models/clip/tiling.py::tiled_image_features_batch(params)": _PARAMS,
    "models/clip/tiling.py::tiled_image_features_depthscaled(params)":
        _PARAMS,
}

# names this slice ported: none of them may hide in NO_COUNTERPART
PORTED = (
    "native.py", "cli/query.py", "cli/extract_obj.py", "cli/test2d.py",
    "cli/viz.py", "cli/doctor.py", "cli/fetch_assets.py",
    "core/geometry.py::scale_intrinsics", "core/geometry.py::cam_to_world",
    "core/sampling.py::grid_sample_2d", "core/sampling.py::trilinear_sample",
    "core/sampling.py::grid_sample_3d", "models/clip/tiling.py::get_patches",
    "models/clip/tiling.py::tiled_image_features",
    "models/clip/engine.py::ClipEngine.img_inference_tiled",
    "models/kmax/model.py::panoptic_class_map",
    "grid/voxel_grid.py::FusionGrid.feature_dim",
    "grid/voxel_grid.py::FusionGrid.num_voxels",
    "grid/voxel_grid.py::FusionGrid.nvox_tuple",
    "parallel/multihost.py::checksums",
    "meshing/extract.py::run_marching_tetrahedra",
)


def _modules(pkg):
    out = []
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(d, f), pkg))
    return sorted(out)


def public_names(path):
    """Public top-level functions, classes and assigned names of a module,
    and each public class's public methods as "Class.method"."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and not m.name.startswith("_")}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for e in [t] if isinstance(t, ast.Name) else getattr(
                        t, "elts", []):
                    if isinstance(e, ast.Name) and not e.id.startswith("_"):
                        out.add(e.id)
    return out


def exported_names(path):
    """What a JAX `__init__` offers: its imported and defined public names,
    and the keys of a lazy-import `_LAZY` table."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for a in node.names:
                out[a.asname or a.name] = node.module
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                out[node.name] = None
        elif (isinstance(node, ast.Assign)
              and [t.id for t in node.targets
                   if isinstance(t, ast.Name)] == ["_LAZY"]):
            for k in ast.literal_eval(node.value):
                out[k] = None
    return out


def _port_index():
    return {rel: public_names(os.path.join(PORT_PKG, rel))
            for rel in _modules(PORT_PKG)}


def test_every_jax_name_has_a_counterpart():
    port = _port_index()
    missing = []
    for rel in _modules(JAX_PKG):
        if rel.endswith("__init__.py"):
            continue
        target = MIRROR.get(rel, rel)
        have = port.get(target, set())
        for name in sorted(public_names(os.path.join(JAX_PKG, rel))):
            key = f"{rel}::{name}"
            if name in have or key in NO_COUNTERPART:
                continue
            if key in RENAMED:
                mod, new = RENAMED[key].split("::")
                assert new in port.get(mod, set()), (key, RENAMED[key])
                continue
            missing.append(f"{key} (port: {target})")
    assert not missing, "\n".join(missing)


def test_tables_are_not_stale():
    port = _port_index()
    for key in list(RENAMED) + list(NO_COUNTERPART):
        rel, name = key.split("::")
        assert name in public_names(os.path.join(JAX_PKG, rel)), key
    for key in NO_COUNTERPART:
        rel, name = key.split("::")
        assert name not in port.get(MIRROR.get(rel, rel), set()), (
            f"{key} has a counterpart now: take it out of NO_COUNTERPART")
    for key, reason in NO_COUNTERPART.items():
        assert reason and "\n" not in reason, key
        assert not any(key == p or key.startswith(p + "::")
                       for p in PORTED), key


@pytest.mark.parametrize("init", [
    rel for rel in _modules(JAX_PKG) if rel.endswith("__init__.py")])
def test_init_exports(init):
    pkg = os.path.dirname(init).replace(os.sep, ".")
    port = importlib.import_module(
        "spatially_aware_ai_tpu_torch" + (f".{pkg}" if pkg else ""))
    missing = []
    for name, module in sorted(exported_names(
            os.path.join(JAX_PKG, init)).items()):
        if module is not None:
            src = os.path.join(os.path.dirname(init),
                               module.replace(".", os.sep) + ".py")
            key = f"{src}::{name}"
            if key in NO_COUNTERPART:
                continue
            if key in RENAMED:
                name = RENAMED[key].split("::")[1].split(".")[0]
        if not hasattr(port, name):
            missing.append(name)
    assert not missing, f"{init}: {missing}"


def _signatures(path):
    """Parameter names (self / cls dropped) of a module's public functions
    and of its public classes' public methods and `__init__`, by
    "name" / "Class.method"."""
    with open(path) as f:
        tree = ast.parse(f.read())

    def params(fn):
        a = fn.args
        return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
                if x.arg not in ("self", "cls")]

    fns = (ast.FunctionDef, ast.AsyncFunctionDef)
    out = {}
    for node in tree.body:
        if isinstance(node, fns) and not node.name.startswith("_"):
            out[node.name] = params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if isinstance(m, fns) and (not m.name.startswith("_")
                                           or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = params(m)
    return out


def test_every_jax_parameter_has_a_counterpart():
    """How a missing option hides from the name check (a KmaxSegmenter
    without the JAX package's compute_dtype): each parameter of a JAX
    function or method whose counterpart exists is one of the
    counterpart's parameters, renamed in PARAM_RENAMED (whose target must
    be a parameter there), or in PARAM_NO_COUNTERPART with its reason;
    neither table goes stale."""
    port = {rel: _signatures(os.path.join(PORT_PKG, rel))
            for rel in _modules(PORT_PKG)}
    missing, used = [], set()
    for rel in _modules(JAX_PKG):
        for name, params in sorted(
                _signatures(os.path.join(JAX_PKG, rel)).items()):
            key = f"{rel}::{name}"
            mod, new = (RENAMED[key].split("::") if key in RENAMED
                        else (MIRROR.get(rel, rel), name))
            have = port.get(mod, {}).get(new)
            if have is None:
                continue
            for p in params:
                pkey = f"{key}({p})"
                if pkey in PARAM_RENAMED:
                    assert PARAM_RENAMED[pkey] in have, (pkey, have)
                    used.add(pkey)
                elif pkey in PARAM_NO_COUNTERPART:
                    assert p not in have, (
                        f"{pkey} has a counterpart now: take it out of "
                        "PARAM_NO_COUNTERPART")
                    used.add(pkey)
                elif p not in have:
                    missing.append(f"{pkey} (port: {mod}::{new}{have})")
    assert not missing, "\n".join(missing)
    stale = (set(PARAM_RENAMED) | set(PARAM_NO_COUNTERPART)) - used
    assert not stale, sorted(stale)
    for pkey, reason in PARAM_NO_COUNTERPART.items():
        assert reason and "\n" not in reason, pkey
