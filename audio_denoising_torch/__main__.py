import sys

from audio_denoising_torch.cli import main

sys.exit(main())
