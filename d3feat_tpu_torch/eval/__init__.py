from d3feat_tpu_torch.eval.gtlog import load_gt_log, save_gt_log  # noqa: F401
from d3feat_tpu_torch.eval.matching import (  # noqa: F401
    inlier_stats,
    mutual_nn,
    mutual_nn_numpy,
    select_keypoints,
)
from d3feat_tpu_torch.eval.registration import (  # noqa: F401
    FragmentFeatures,
    SceneResult,
    evaluate_scenes,
    register_scene,
)
from d3feat_tpu_torch.eval.extract import FeatureExtractor, generate_features  # noqa: F401
