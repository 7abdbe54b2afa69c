from tpu_audio_torch.app.main import main

if __name__ == "__main__":
    raise SystemExit(main())
