"""--profile-dir and --debug-nans refused where JAX's loop does not read
them (ROADMAP C24): --profile-dir off classification training,
--debug-nans off classification and part-segmentation training, and both
on the semantic-segmentation trainer, whose CLI has neither. The flags at
work are tests/test_torch_profile_flag.py."""

import pytest

from svnet_tpu_torch.cli import flags
from svnet_tpu_torch.cli.main_semseg import build_parser as semseg_parser


@pytest.mark.parametrize("task,argv", [
    ("partseg", ["--profile-dir", "p"]),
    ("cls", ["--profile-dir", "p", "--test", "ckpt"]),
    ("cls", ["--debug-nans", "--test", "ckpt"]),
    ("partseg", ["--debug-nans", "--test", "ckpt"]),
])
def test_flags_refused_where_they_do_not_act(task, argv):
    """C24: --profile-dir off classification training, --debug-nans off
    training."""
    with pytest.raises(ValueError):
        flags.check_ported(flags.build_parser(task, "dgcnn").parse_args(argv))


@pytest.mark.parametrize("flag,value", [("profile_dir", "p"),
                                        ("debug_nans", True)])
def test_semseg_refuses_both_flags(flag, value):
    """The semantic-segmentation trainer reads neither (its CLI has no such
    flags, as JAX's has none): a namespace that sets one is refused."""
    args = semseg_parser().parse_args([])
    flags.check_ported(args)
    setattr(args, flag, value)
    with pytest.raises(ValueError):
        flags.check_ported(args)
