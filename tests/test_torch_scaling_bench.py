"""rec_tpu_torch's ``cli.scaling_bench`` at its tiny size on the CPU, all
three modes over ``[cpu] * 2`` meshes (rec_tpu's bench runs on its virtual
CPU devices the same way; neither gives a card's rates)."""

import json

from rec_tpu_torch.cli import scaling_bench


class TestScalingBench:
    def test_all_modes_at_the_tiny_size(self, tmp_path):
        """serve on 4 images in batches of 2 (1 process x 2 entries, 2
        processes x 1 and the 1 x 1 base; the two 2-device runs' files
        identical), codec (a 1- and a 2-entry mesh,
        bitwise equal) and hlo (no NCCL kernel or card-to-card copy in a
        sharded batch's trace)."""
        lines = scaling_bench.main(["mode=all", "size=tiny", "device=cpu",
                                    "num_images=4", "batch_size=2",
                                    f"output_dir={tmp_path}"])
        by_mode = {line["mode"]: line for line in lines}
        assert set(by_mode) == {"serve", "codec", "hlo"}
        serve = by_mode["serve"]
        assert serve["device"] == "cpu" and serve["ks"] == [2]
        assert serve["files_identical"]
        assert set(serve["runs"]) == {"1x1", "1x2", "2x1"}
        assert by_mode["codec"]["bitwise_equal"]
        assert by_mode["hlo"]["collectives"] == 0
        assert by_mode["hlo"]["events"] > 0
        saved = json.loads((tmp_path / "scaling.json").read_text())
        assert set(saved) == {"serve", "codec", "hlo"}
